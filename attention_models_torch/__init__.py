"""attention-models-torch: the PyTorch/CUDA port of attention-models-tpu.

A package beside ``attention_models_tpu`` (the JAX reference it is held
against), for one NVIDIA H100. It imports torch and never JAX.

- ``ops``       — kernel wrappers and their plain versions: flash attention on
                  packed kv and the fused LN + MLP block (forward and
                  backward), LayerNorm, the nearest-code argmin, the GEGLU
                  FFN, the samplers and the fused sampling epilogue; the
                  autograd Functions around them. Kernels are CUDA C++ in
                  ``csrc/``, built with nvcc at first use (``ops/_build.py``).
- ``models``    — the ViTVQGAN tokenizer with the reference's parameter
                  names, the PatchGAN discriminator, the transformer encoder
                  and MaskGIT over the tokenizer, ``build_model``.
- ``training``  — GAN losses and LPIPS, optax-style Adam, schedules, the
                  base and ViTVQGAN trainers.
- ``data``      — synthetic and COCO datasets, the transform, the loader.
- ``utils``     — config, checkpoints, metrics, eval metrics, flax params ->
                  ``state_dict`` conversion.
- ``serving``   — the tokenize, reconstruct and MaskGIT batch programs.
- ``entry``     — the serving path's entry point; ``main`` the training CLI.
"""

__version__ = "0.1.0"


def sync() -> None:
    """Wait for the card: every timing of the port ends with this."""
    import torch

    torch.cuda.synchronize()
