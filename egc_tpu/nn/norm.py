"""Masked BatchNorm — torch.nn.BatchNorm1d semantics over valid rows only.

The reference's batches are exactly-sized so plain BatchNorm1d works
(reference ``experiments/zinc/models.py:41``); batches here are padded, so the
statistics must ignore padding rows or they would be diluted by zeros. This
is correctness-critical (SURVEY §7.0).

Torch parity details:
- normalization uses the *biased* batch variance (divide by n);
- running_var is updated with the *unbiased* estimate (n/(n-1));
- ``running = (1 - momentum) * running + momentum * batch`` with momentum 0.1;
- eps 1e-5 inside the sqrt.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from egc_tpu.nn.module import Module


class MaskedBatchNorm(Module):
    momentum: float = 0.1
    eps: float = 1e-5
    use_scale: bool = True
    use_bias: bool = True
    dtype: Optional[jnp.dtype] = None
    axis_name: Optional[str] = None   # sync-BN across a mesh axis (psum)

    def __call__(self, x, mask=None, *, use_running_average: bool):
        """x: [N, F]; mask: [N] bool or None (None = all rows valid).

        With ``axis_name`` set (inside shard_map/pmap), statistics are
        computed over the GLOBAL batch via psum — data-parallel training
        then matches single-device numerics exactly.
        """
        features = x.shape[-1]
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros((features,), jnp.float32))
        ra_var = self.variable("batch_stats", "var",
                               lambda: jnp.ones((features,), jnp.float32))

        if use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            xf = x.astype(jnp.float32)
            if mask is None:
                s = jnp.sum(xf, axis=0)
                ssq = jnp.sum(jnp.square(xf), axis=0)
                n = jnp.asarray(x.shape[0], jnp.float32)
            else:
                m = mask.astype(jnp.float32)[:, None]
                s = jnp.sum(xf * m, axis=0)
                ssq = jnp.sum(jnp.square(xf) * m, axis=0)
                n = jnp.sum(m)
            if self.axis_name is not None:
                s = jax.lax.psum(s, self.axis_name)
                ssq = jax.lax.psum(ssq, self.axis_name)
                n = jax.lax.psum(n, self.axis_name)
            n = jnp.maximum(n, 1.0)
            mean = s / n
            var = jnp.maximum(ssq / n - jnp.square(mean), 0.0)
            if not self.is_initializing():
                unbiased = var * n / jnp.maximum(n - 1.0, 1.0)
                ra_mean.value = (1 - self.momentum) * ra_mean.value + \
                    self.momentum * mean
                ra_var.value = (1 - self.momentum) * ra_var.value + \
                    self.momentum * unbiased

        y = (x.astype(jnp.float32) - mean) * jnp.reciprocal(
            jnp.sqrt(var + self.eps))
        if self.use_scale:
            scale = self.param("scale", jax.nn.initializers.ones, (features,),
                               jnp.float32)
            y = y * scale
        if self.use_bias:
            bias = self.param("bias", jax.nn.initializers.zeros, (features,),
                              jnp.float32)
            y = y + bias
        return y.astype(self.dtype or x.dtype)
