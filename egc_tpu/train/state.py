"""Training state pytree (params + batch stats + optimizer state)."""

from __future__ import annotations

from typing import Any

import jax
import optax

from egc_tpu.utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class TrainState:
    params: Any
    batch_stats: Any
    opt_state: Any
    step: int
    tx: optax.GradientTransformation = static_field()

    @classmethod
    def create(cls, *, params, batch_stats, tx):
        return cls(params=params, batch_stats=batch_stats,
                   opt_state=tx.init(params), step=0, tx=tx)

    def apply_gradients(self, grads, new_batch_stats=None):
        updates, new_opt = self.tx.update(grads, self.opt_state, self.params)
        new_params = optax.apply_updates(self.params, updates)
        return self.replace(
            params=new_params,
            batch_stats=(new_batch_stats if new_batch_stats is not None
                         else self.batch_stats),
            opt_state=new_opt,
            step=self.step + 1,
        )

    @property
    def num_params(self) -> int:
        return sum(x.size for x in jax.tree.leaves(self.params))
