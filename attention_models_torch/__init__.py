"""attention-models-torch: the PyTorch/CUDA port of attention-models-tpu.

A package beside ``attention_models_tpu`` (the JAX reference it is held
against), for one NVIDIA H100. It imports torch and never JAX.

- ``ops``       — kernel wrappers and their plain versions: flash attention on
                  packed kv, the fused LN + MLP block, LayerNorm, the
                  nearest-code argmin. Kernels are CUDA C++ in ``csrc/``, built
                  with nvcc at first use (``ops/_build.py``).
- ``models``    — the ViTVQGAN tokenizer with the reference's parameter names.
- ``utils``     — flax params -> ``state_dict`` conversion.
- ``serving``   — the tokenize and reconstruct batch programs.
- ``entry``     — the main path's entry point.
"""

__version__ = "0.1.0"


def sync() -> None:
    """Wait for the card: every timing of the port ends with this."""
    import torch

    torch.cuda.synchronize()
