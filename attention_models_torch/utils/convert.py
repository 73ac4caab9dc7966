"""flax params -> the port's ``state_dict``s.

Written against plain nested dicts of arrays (anything ``np.asarray`` takes),
so this module needs neither JAX nor flax:
- ``from_jax_params``: the ViTVQGAN generator, the inverse of
  ``attention_models_tpu/utils/torch_convert.py::convert_vitvqgan``. Dense
  kernels (in, out) are transposed to torch Linear weights (out, in);
  LayerNorm gamma/beta become weight/bias; names become the reference
  PyTorch keys.
- ``maskgit_from_jax``: ``MaskGitTransformer`` (its ``vq`` subtree through
  ``from_jax_params``); gamma-only LayerNorms keep ``gamma`` and gain their
  zero ``beta`` buffer.
- ``vit_from_jax``: the ViT classifier (``models.vit.ViT``); the JAX
  package has no torch converter for it (the reference ViT is broken,
  SURVEY §2.9#3), so the keys are the port's own.
- ``muse_from_jax``: ``MUSE``: the decoder with the keys of
  ``torch_convert.py::convert_decoder``, the CLIP tower with those of
  ``convert_hf_clip_text``, the tokenizer through ``from_jax_params``. A
  quantized model takes the same weights (it quantizes them at use).
- ``vit_moe_from_jax``: ``models.vit_moe.ViTMoE``, with the keys of
  ``torch_convert.py::convert_vit_moe``; ``switchhead_from_jax``,
  ``moe_layer_from_jax`` and ``agent_attention_from_jax`` (the keys of
  ``convert_switchhead_attention``, ``convert_moe_layer`` and
  ``convert_agent_attention``) convert one module. The expert banks keep
  JAX's stacked (E, d_in, d_out) layout under JAX's names
  (``experts_v``, ``experts_out``, ``experts_kernel``, ``experts_bias``),
  where the reference has one ``Linear`` an expert
  (``experts_v.{i}.weight`` (out, in), ...).
- ``discriminator_from_jax``: ``NLayerDiscriminator`` params and
  ``batch_stats``.
- ``lpips_from_jax``: the LPIPS VGG16 tower and its 1x1 heads.
Conv kernels go from flax HWIO to torch OIHW.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lin(tree: Mapping, key: str, sd: dict) -> None:
    sd[f"{key}.weight"] = _t(tree["kernel"]).T.contiguous()
    if "bias" in tree:
        sd[f"{key}.bias"] = _t(tree["bias"])


def _ln(tree: Mapping, key: str, sd: dict) -> None:
    sd[f"{key}.weight"] = _t(tree["gamma"])
    sd[f"{key}.bias"] = _t(tree["beta"])


def _blocks(tower: Mapping, key: str, sd: dict) -> None:
    depth = sum(1 for name in tower if name.startswith("layers_"))
    for i in range(depth):
        blk, p = tower[f"layers_{i}"], f"{key}.layers.{i}"
        _ln(blk["norm1"], f"{p}.norm1", sd)
        _lin(blk["self_attn"]["wq"], f"{p}.self_attn.q.0", sd)
        _lin(blk["self_attn"]["wkv"], f"{p}.self_attn.kv.0", sd)
        _lin(blk["self_attn"]["wo"], f"{p}.self_attn.W_o", sd)
        _ln(blk["norm2"], f"{p}.norm2", sd)
        _lin(blk["mlp"]["mlp_in"], f"{p}.feed_forward.0", sd)
        _lin(blk["mlp"]["mlp_out"], f"{p}.feed_forward.2", sd)


def from_jax_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """ViTVQGAN flax params (with or without the top-level ``"params"``)
    -> fp32 ``state_dict`` for ``models.vitvqgan.ViTVQGAN``."""
    if "params" in tree:
        tree = tree["params"]
    sd: dict[str, torch.Tensor] = {}
    enc, dec = tree["encoder"], tree["decoder"]
    pe = enc["patch_embed"]
    _ln(pe["norm1"], "encoder.to_patch_embedding.1", sd)
    _lin(pe["proj"], "encoder.to_patch_embedding.2", sd)
    _ln(pe["norm2"], "encoder.to_patch_embedding.3", sd)
    sd["encoder.pos_enc"] = _t(enc["pos_enc"])
    _ln(enc["pre_norm"], "encoder.pre_norm", sd)
    _blocks(enc, "encoder.encoder", sd)
    _lin(tree["pre_quant"], "pre_quant", sd)
    sd["codebook.embedding.weight"] = _t(tree["codebook"]["embedding"])
    _lin(tree["post_quant"], "post_quant", sd)
    sd["decoder.pos_enc"] = _t(dec["pos_enc"])
    _ln(dec["pre_norm"], "decoder.pre_norm", sd)
    _blocks(dec, "decoder.decoder", sd)
    _lin(dec["fc"], "decoder.fc", sd)
    return sd


def _gamma_ln(tree: Mapping, key: str, sd: dict) -> None:
    sd[f"{key}.gamma"] = _t(tree["gamma"])
    sd[f"{key}.beta"] = torch.zeros_like(sd[f"{key}.gamma"])


def maskgit_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """flax ``MaskGitTransformer`` params (with or without the top-level
    ``"params"``) -> fp32 ``state_dict`` for
    ``models.maskgit.MaskGitTransformer``."""
    if "params" in tree:
        tree = tree["params"]
    sd = {f"vq.{k}": v for k, v in from_jax_params(tree["vq"]).items()}
    bt, p = tree["bidirectional_transformer"], "bidirectional_transformer"
    sd[f"{p}.input_proj.weight"] = _t(bt["input_proj"]["embedding"])
    sd[f"{p}.pos_enc"] = _t(bt["pos_enc"])
    _gamma_ln(bt["init_norm"], f"{p}.init_norm", sd)
    for i, blk in enumerate(_layers(bt["decoder"])):
        q = f"{p}.decoder.layers.{i}"
        _gamma_ln(blk["norm1"], f"{q}.norm1", sd)
        _attention(blk["self_attn"], f"{q}.self_attn", sd)
        _gamma_ln(blk["norm2"], f"{q}.norm2", sd)
        _feed_forward(blk["ff"], f"{q}.feed_forward", sd)
    _gamma_ln(bt["final_norm"], f"{p}.final_norm", sd)
    sd[f"{p}.linear.weight"] = _t(bt["linear"]["kernel"]).T.contiguous()
    return sd


def vit_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """flax ``ViT`` params (with or without the top-level ``"params"``) ->
    fp32 ``state_dict`` for ``models.vit.ViT``."""
    if "params" in tree:
        tree = tree["params"]
    pe, p = tree["patch_embed"], "to_patch_embedding"
    sd: dict[str, torch.Tensor] = {}
    _ln(pe["norm1"], f"{p}.1", sd)
    _lin(pe["proj"], f"{p}.2", sd)
    _ln(pe["norm2"], f"{p}.3", sd)
    sd["class_token"] = _t(tree["class_token"])
    sd["pos_enc"] = _t(tree["pos_enc"])
    for i, blk in enumerate(_layers(tree)):
        q = f"layers.{i}"
        _gamma_ln(blk["norm1"], f"{q}.norm1", sd)
        _attention(blk["self_attn"], f"{q}.self_attn", sd)
        _gamma_ln(blk["norm2"], f"{q}.norm2", sd)
        _lin(blk["mlp"]["mlp_in"], f"{q}.mlp.0", sd)
        _lin(blk["mlp"]["mlp_out"], f"{q}.mlp.2", sd)
    _lin(tree["final_fc"], "final_fc", sd)
    return sd


def _attention(tree: Mapping, key: str, sd: dict) -> None:
    _lin(tree["wq"], f"{key}.q.0", sd)
    _lin(tree["wkv"], f"{key}.kv.0", sd)
    _lin(tree["wo"], f"{key}.W_o", sd)


def _feed_forward(tree: Mapping, key: str, sd: dict) -> None:
    _lin(tree["ff_in"], f"{key}.ff.0", sd)
    _gamma_ln(tree["norm"], f"{key}.ff.2", sd)
    _lin(tree["ff_out"], f"{key}.ff.3", sd)


def _layers(tree: Mapping) -> list:
    return [tree[f"layers_{i}"]
            for i in range(sum(1 for k in tree if k.startswith("layers_")))]


def muse_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """flax ``MUSE`` params (with or without the top-level ``"params"``)
    -> fp32 ``state_dict`` for ``models.muse.MUSE``."""
    if "params" in tree:
        tree = tree["params"]
    sd = {f"vq.{k}": v for k, v in from_jax_params(tree["vq"]).items()}
    te = tree["text_encoder"]
    clip, p = te["clip"], "text_encoder.clip.text_model"
    sd[f"{p}.embeddings.token_embedding.weight"] = _t(
        clip["token_embedding"]["embedding"])
    sd[f"{p}.embeddings.position_embedding.weight"] = _t(
        clip["position_embedding"])
    for i, blk in enumerate(_layers(clip)):
        q = f"{p}.encoder.layers.{i}"
        _ln(blk["ln1"], f"{q}.layer_norm1", sd)
        for name in ("q", "k", "v"):
            _lin(blk[f"w{name}"], f"{q}.self_attn.{name}_proj", sd)
        _lin(blk["wo"], f"{q}.self_attn.out_proj", sd)
        _ln(blk["ln2"], f"{q}.layer_norm2", sd)
        _lin(blk["fc1"], f"{q}.mlp.fc1", sd)
        _lin(blk["fc2"], f"{q}.mlp.fc2", sd)
    _ln(clip["final_ln"], f"{p}.final_layer_norm", sd)
    _lin(te["project_embeds"], "text_encoder.project_embeds", sd)
    dec, p = tree["decoder"], "decoder"
    sd[f"{p}.token_emb.weight"] = _t(dec["token_emb"]["embedding"])
    sd[f"{p}.pos_enc"] = _t(dec["pos_enc"])
    for i, blk in enumerate(_layers(dec["decoder"])):
        q = f"{p}.decoder.layers.{i}"
        _attention(blk["self_attn"], f"{q}.self_attn", sd)
        _attention(blk["cross_attn"], f"{q}.cross_attn", sd)
        _feed_forward(blk["ff"], f"{q}.feed_forward", sd)
        for n in ("norm1", "norm2", "norm3"):
            _gamma_ln(blk[n], f"{q}.{n}", sd)
    _gamma_ln(dec["final_norm"], f"{p}.final_norm", sd)
    _lin(dec["linear"], f"{p}.linear", sd)
    return sd


def _prefixed(prefix: str) -> str:
    return f"{prefix}." if prefix else ""


def switchhead_from_jax(tree: Mapping, prefix: str = ""
                        ) -> dict[str, torch.Tensor]:
    """flax ``SwitchHeadAttention`` params -> the keys of
    ``models.attention.SwitchHeadAttention`` under ``prefix``."""
    p, sd = _prefixed(prefix), {}
    for name, key in (("wq", "q.0"), ("wk", "k.0"), ("ws", "W_s.0"),
                      ("wd", "W_d.0")):
        _lin(tree[name], f"{p}{key}", sd)
    for name in ("experts_v", "experts_out"):
        sd[f"{p}{name}"] = _t(tree[name])
    return sd


def moe_layer_from_jax(tree: Mapping, prefix: str = ""
                       ) -> dict[str, torch.Tensor]:
    """flax ``MoELayer`` params -> the keys of ``models.moe.MoELayer``."""
    p, sd = _prefixed(prefix), {}
    _lin(tree["gate"], f"{p}gate", sd)
    for name in ("experts_kernel", "experts_bias"):
        sd[f"{p}{name}"] = _t(tree[name])
    return sd


def agent_attention_from_jax(tree: Mapping, prefix: str = ""
                             ) -> dict[str, torch.Tensor]:
    """flax ``AgentAttention`` params -> the keys of
    ``models.attention.AgentAttention``."""
    p, sd = _prefixed(prefix), {}
    _lin(tree["wqkv"], f"{p}qkv", sd)
    _lin(tree["wo"], f"{p}W_o", sd)
    sd[f"{p}bias1"] = _t(tree["bias1"])
    sd[f"{p}bias2"] = _t(tree["bias2"])
    _conv(tree["dwc"], f"{p}dwc.1", sd)
    return sd


def vit_moe_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """flax ``ViTMoE`` params (with or without the top-level ``"params"``)
    -> fp32 ``state_dict`` for ``models.vit_moe.ViTMoE``."""
    if "params" in tree:
        tree = tree["params"]
    pe, p = tree["patch_embed"], "to_patch_embedding"
    sd: dict[str, torch.Tensor] = {}
    _ln(pe["norm1"], f"{p}.1", sd)
    _lin(pe["proj"], f"{p}.2", sd)
    _ln(pe["norm2"], f"{p}.3", sd)
    sd["class_token"] = _t(tree["class_token"])
    sd["pos_enc"] = _t(tree["pos_enc"])
    for i, blk in enumerate(_layers(tree)):
        q = f"encoder.layers.{i}"
        _ln(blk["norm1"], f"{q}.norm1", sd)
        sd.update(switchhead_from_jax(blk["self_attn"], f"{q}.self_attn"))
        _ln(blk["norm2"], f"{q}.norm2", sd)
        sd.update(moe_layer_from_jax(blk["moe"], f"{q}.moe"))
    _ln(tree["norm"], "norm", sd)
    _lin(tree["class_embed"], "class_embed", sd)
    return sd


def _conv(tree: Mapping, key: str, sd: dict) -> None:
    sd[f"{key}.weight"] = _t(tree["kernel"]).permute(3, 2, 0, 1).contiguous()
    if "bias" in tree:
        sd[f"{key}.bias"] = _t(tree["bias"])


def discriminator_from_jax(params: Mapping, batch_stats: Mapping
                           ) -> dict[str, torch.Tensor]:
    """flax ``NLayerDiscriminator`` params + batch_stats -> ``state_dict``
    for ``models.discriminator.NLayerDiscriminator``."""
    sd: dict[str, torch.Tensor] = {}
    for name, tree in params.items():
        if name.startswith("conv"):
            _conv(tree, name, sd)
        else:  # bn{n}
            sd[f"{name}.scale"] = _t(tree["scale"])
            sd[f"{name}.bias"] = _t(tree["bias"])
            sd[f"{name}.mean"] = _t(batch_stats[name]["mean"])
            sd[f"{name}.var"] = _t(batch_stats[name]["var"])
    return sd


def lpips_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """flax ``LPIPS`` params (with or without the top-level ``"params"``)
    -> ``state_dict`` for ``training.losses.LPIPS``."""
    if "params" in tree:
        tree = tree["params"]
    sd: dict[str, torch.Tensor] = {}
    for name, conv in tree["vgg"].items():
        _conv(conv, f"vgg.{name}", sd)
    for i in range(5):
        _conv(tree[f"lin{i}"], f"lins.{i}", sd)
    return sd
