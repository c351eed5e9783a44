"""MLP builder matching the reference's ``mlp()`` helper.

Reference ``experiments/utils.py:30-40``: for layer sizes [l0, l1, ..., lk]:
(Linear -> BatchNorm1d -> act -> Dropout) for each hidden transition, then a
final plain Linear. BatchNorm here is mask-aware (padded rows excluded).
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax

from egc_tpu.nn.module import Module, Dense, Dropout
from egc_tpu.nn import init as einit
from egc_tpu.nn.norm import MaskedBatchNorm


class MLP(Module):
    layer_sizes: Sequence[int]      # output sizes [l1, ..., lk]
    act: Callable = jax.nn.relu
    dropout: float = 0.0
    bn_axis: str = None             # sync-BN mesh axis (optional)

    def __call__(self, x, mask=None, *, train: bool):
        sizes = list(self.layer_sizes)
        for i, size in enumerate(sizes[:-1]):
            fan_in = x.shape[-1]
            x = Dense(size, kernel_init=einit.torch_linear_kernel,
                      bias_init=einit.torch_linear_bias(fan_in))(x)
            x = MaskedBatchNorm(axis_name=self.bn_axis)(x, mask, use_running_average=not train)
            x = self.act(x)
            x = Dropout(self.dropout, deterministic=not train)(x)
        fan_in = x.shape[-1]
        return Dense(sizes[-1], kernel_init=einit.torch_linear_kernel,
                     bias_init=einit.torch_linear_bias(fan_in))(x)
