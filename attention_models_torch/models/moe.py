"""The top-k gated MoE layer.

Counterpart of ``attention_models_tpu/models/moe.py::MoELayer``: a gate
``Linear(input_dim -> E)`` with a bias, the top-k selection with weights
sigmoid(top-k logits), and one routed linear ``input_dim -> output_dim``
with a bias and no activation (the reference's layer), through
``ops/moe.py::moe_linear``: the dense combine for E <= 8, the
capacity-bucketed scatter above (``impl="auto"``). No load-balancing loss;
``capacity_factor=None`` is dropless.

Keys: ``gate.{weight,bias}`` as the reference's; the expert bank is held
stacked as JAX holds it, ``experts_kernel`` (E, input_dim, output_dim) and
``experts_bias`` (E, output_dim), where the reference has one ``Linear``
an expert (``experts.{i}.weight`` (out, in), ``experts.{i}.bias``): the
dispatch is one batched product over the stacked bank.
"""

from __future__ import annotations

import torch
from torch import nn

from attention_models_torch.models.layers import Linear, lecun_normal_
from attention_models_torch.ops.moe import (
    moe_linear,
    resolve_moe_impl,
    topk_gate,
)


class MoELayer(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, num_experts: int,
                 sel_experts: int, impl: str = "auto",
                 capacity_factor: float | None = None):
        super().__init__()
        self.sel_experts = sel_experts
        self.impl = resolve_moe_impl(impl, num_experts)
        self.capacity_factor = capacity_factor
        self.gate = Linear(input_dim, num_experts)
        self.experts_kernel = nn.Parameter(
            torch.empty(num_experts, input_dim, output_dim))
        self.experts_bias = nn.Parameter(torch.zeros(num_experts, output_dim))
        self.reset_experts()

    def reset_experts(self, generator: torch.Generator | None = None) -> None:
        """flax's inits of the bank: lecun-normal (fan_in E * input_dim),
        zero bias."""
        e, d_in, _ = self.experts_kernel.shape
        with torch.no_grad():
            lecun_normal_(self.experts_kernel, generator, fan_in=e * d_in)
            self.experts_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights, selected = topk_gate(self.gate(x), self.sel_experts)
        return moe_linear(x, self.experts_kernel, selected, weights,
                          self.experts_bias, impl=self.impl,
                          capacity_factor=self.capacity_factor)
