"""Optimizers with the JAX package's optax semantics.

Counterpart of ``attention_models_tpu/training/optim.py``. ``build_optimizer``
returns an ``OptaxAdam``, which applies, to the gradients handed to ``step``:

1. accumulation as ``optax.MultiSteps(k)``: the running mean of k
   micro-gradients, a zero update on the other micro-steps;
2. on the k-th micro-step, clipping of that mean as
   ``optax.clip_by_global_norm``: ``g * max / |g|`` when ``|g| > max``
   (no epsilon, unlike ``clip_grad_norm_``), the norm accumulated in
   fp64 (the CPU's fp32 norm sums a tensor in one run: 3e-5 off at the
   CNN VQGAN's 2.4M-element convs, where XLA's pairwise sum keeps
   fp32 accuracy);
3. ``adam``: weight decay as L2 added to the gradient before the moments
   (torch ``Adam``; JAX ``add_decayed_weights`` chained before ``adam``);
   ``adamw``: decoupled, ``lr * wd * p``;
4. bias-corrected moments (``eps`` outside the square root, as optax) and
   the rate ``schedule(count)``, count being the optimizer steps taken so
   far, which is ``global_step // k`` at the step that updates.

Moments are ``exp_avg`` / ``exp_avg_sq`` and the accumulator ``acc_grad``
in each parameter's state; the counters and the per-parameter decay flags
live in the param group, so ``state_dict`` / ``load_state_dict`` carry
everything.

The generator trainers build it over a module with ``frozen_subtrees``
(``optax.masked`` + ``set_to_zero`` in JAX): the frozen parameters are left
out, so they hold no moments and never move; and, for adamw with weight
decay, ``no_decay_grouping``: the decoupled decay applies only where
``decay_mask`` says, judged on each parameter's flax path.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch
from torch import nn

NO_DECAY_NAMES = ("bias", "beta", "gamma", "scale", "embedding", "pos_enc",
                  "class_token", "bias1", "bias2", "start_token")


class OptaxAdam(torch.optim.Optimizer):
    def __init__(self, params, schedule: Callable[[int], float], *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = False,
                 max_grad_norm: float | None = None, accum_steps: int = 1,
                 decay: Sequence[bool] | None = None):
        """``decay``: one flag per parameter, whether the weight decay
        applies to it (default: to every one)."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        defaults = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                        decoupled=decoupled, max_grad_norm=max_grad_norm,
                        accum_steps=accum_steps, count=0, mini_step=0)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("OptaxAdam takes one parameter group")
        group = self.param_groups[0]
        group["decay"] = ([True] * len(group["params"]) if decay is None
                          else [bool(f) for f in decay])
        if len(group["decay"]) != len(group["params"]):
            raise ValueError("one decay flag per parameter")
        self.schedule = schedule

    @property
    def count(self) -> int:
        """Optimizer steps taken (the schedule's argument)."""
        return self.param_groups[0]["count"]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor | None]) -> bool:
        """One micro-step with ``grads`` (one per parameter, None = zero).
        Returns True when the parameters were updated. Every update is a
        multi-tensor (``torch._foreach_*``) op over all parameters at once."""
        group = self.param_groups[0]
        params = group["params"]
        if len(grads) != len(params):
            raise ValueError(f"{len(grads)} gradients for {len(params)} "
                             f"parameters")
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if "exp_avg" not in self.state[params[0]]:
            for p in params:
                st = self.state[p]
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
                if group["accum_steps"] > 1:
                    st["acc_grad"] = torch.zeros_like(p)
        k, n_acc = group["accum_steps"], group["mini_step"]
        if k > 1:
            acc = [self.state[p]["acc_grad"] for p in params]
            diff = torch._foreach_sub(grads, acc)
            torch._foreach_div_(diff, float(n_acc + 1))
            torch._foreach_add_(acc, diff)
            if n_acc + 1 < k:
                group["mini_step"] = n_acc + 1
                return False
            group["mini_step"] = 0
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
        else:
            grads = [g.clone() for g in grads]

        max_norm = group["max_grad_norm"]
        if max_norm:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads, 2, dtype=torch.float64)))
            factor = torch.where(norm < max_norm, torch.ones_like(norm),
                                 max_norm / norm)
            torch._foreach_mul_(grads, factor.float())

        b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], \
            group["weight_decay"]
        lr = float(self.schedule(group["count"]))
        group["count"] += 1
        c = group["count"]
        decayed = [i for i, f in enumerate(group["decay"]) if f]
        if wd and not group["decoupled"] and decayed:
            torch._foreach_add_([grads[i] for i in decayed],
                                [params[i] for i in decayed], alpha=wd)
        m = [self.state[p]["exp_avg"] for p in params]
        v = [self.state[p]["exp_avg_sq"] for p in params]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        upd = torch._foreach_div(m, 1.0 - b1 ** c)
        den = torch._foreach_div(v, 1.0 - b2 ** c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(upd, den)
        if wd and group["decoupled"] and decayed:
            torch._foreach_add_([upd[i] for i in decayed],
                                [params[i] for i in decayed], alpha=wd)
        torch._foreach_add_(params, upd, alpha=-lr)
        return True


def flax_paths(module: nn.Module) -> dict[str, tuple[str, ...]]:
    """Each parameter's key -> the parts of its flax path that the JAX
    masks test: the module path, then the leaf as flax names it (a torch
    Linear's ``weight`` is a flax ``kernel``, an Embedding's an
    ``embedding``, a LayerNorm's ``weight`` / ``bias`` are ``gamma`` /
    ``beta``). So ``input_proj.weight`` is ``input_proj/embedding`` and
    stays undecayed, as in JAX."""
    leaf_names = {nn.Linear: {"weight": "kernel"},
                  nn.Conv2d: {"weight": "kernel"},
                  nn.Embedding: {"weight": "embedding"}}
    out = {}
    for mname, m in module.named_modules():
        names = next((v for t, v in leaf_names.items() if isinstance(m, t)),
                     {"weight": "gamma", "bias": "beta"}
                     if type(m).__name__ == "LayerNorm" else {})
        for pname, _ in m.named_parameters(recurse=False):
            parts = tuple(mname.split(".")) if mname else ()
            out[f"{mname}.{pname}" if mname else pname] = parts + (
                names.get(pname, pname),)
    return out


def decay_mask(module: nn.Module,
               no_decay_names: Sequence[str] = NO_DECAY_NAMES
               ) -> dict[str, bool]:
    """True where weight decay applies: tensors of 2+ dims whose flax path
    holds none of ``no_decay_names`` (``training/optim.py::decay_mask``)."""
    params = dict(module.named_parameters())
    return {k: params[k].dim() >= 2 and not set(parts) & set(no_decay_names)
            for k, parts in flax_paths(module).items()}


def frozen_mask(module: nn.Module,
                frozen_subtrees: Sequence[str]) -> dict[str, bool]:
    """True where a parameter is trainable (outside the frozen subtrees)."""
    return {k: not set(parts) & set(frozen_subtrees)
            for k, parts in flax_paths(module).items()}


def build_optimizer(cfg, schedule: Callable[[int], float],
                    params: Sequence[torch.Tensor] | nn.Module,
                    frozen_subtrees: Sequence[str] = (),
                    no_decay_grouping: bool = False) -> OptaxAdam:
    """The config's ``optimizer`` (adam / adamw) with ``training.
    max_grad_norm`` and ``training.gradient_accumulation_steps``, over a
    list of parameters or, with ``frozen_subtrees`` / ``no_decay_grouping``,
    over a module's trainable parameters in ``named_parameters`` order."""
    name = cfg.optimizer.name
    if name not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {name!r}")
    p = cfg.optimizer.params
    wd = float(p.get("weight_decay", 0.0) or 0.0)
    decay = None
    if isinstance(params, nn.Module):
        module = params
        named: Mapping[str, torch.Tensor] = dict(module.named_parameters())
        keep = frozen_mask(module, frozen_subtrees)
        keys = [k for k in named if keep[k]]
        params = [named[k] for k in keys]
        if name == "adamw" and no_decay_grouping and wd > 0:
            mask = decay_mask(module)
            decay = [mask[k] for k in keys]
    elif frozen_subtrees or no_decay_grouping:
        raise TypeError("frozen_subtrees / no_decay_grouping need the "
                        "module, to name its parameters")
    max_norm = cfg.training.get("max_grad_norm")
    return OptaxAdam(
        params, schedule, b1=float(p.beta1), b2=float(p.beta2),
        eps=float(p.get("epsilon", 1e-8) or 1e-8), weight_decay=wd,
        decoupled=name == "adamw",
        max_grad_norm=float(max_norm) if max_norm else None,
        accum_steps=int(cfg.training.get("gradient_accumulation_steps", 1)
                        or 1),
        decay=decay,
    )
