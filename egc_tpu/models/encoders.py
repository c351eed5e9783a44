"""Input feature encoders for the task models.

- ``AtomEncoder``: OGB molecule atom encoder — one embedding table per
  categorical atom feature, summed (reference imports it from
  ``ogb.graphproppred.mol_encoder``, ``experiments/mol/pna_style_models.py:5``;
  re-implemented here with the same feature-cardinality table and
  xavier-uniform init).
- ``ASTNodeEncoder``: ogbg-code2 AST node encoder — type + attribute +
  clamped-depth embeddings summed (reference
  ``experiments/code/models.py:27-45``).
"""

from __future__ import annotations

import jax.numpy as jnp

from egc_tpu.nn.module import Module, Embed
from egc_tpu.nn import init as einit

# ogb.utils.features.get_atom_feature_dims(): cardinalities of the 9
# categorical atom features in OGB mol datasets.
ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)


class AtomEncoder(Module):
    emb_dim: int

    def __call__(self, x):
        """x: [N, 9] int — returns [N, emb_dim]."""
        out = 0.0
        for i, dim in enumerate(ATOM_FEATURE_DIMS):
            emb = Embed(dim, self.emb_dim,
                        embedding_init=einit.glorot_uniform,
                        name=f"atom_emb_{i}")
            out = out + emb(x[:, i])
        return out


class ASTNodeEncoder(Module):
    emb_dim: int
    num_nodetypes: int = 98          # reference experiments/code/utils.py:13
    num_nodeattributes: int = 10030  # code2 (old code dataset: 10003)
    max_depth: int = 20

    def __call__(self, x, depth):
        """x: [N, 2] int (type, attr); depth: [N] int."""
        depth = jnp.minimum(depth, self.max_depth)
        t = Embed(self.num_nodetypes, self.emb_dim,
                  embedding_init=einit.normal_embedding, name="type")(x[:, 0])
        a = Embed(self.num_nodeattributes, self.emb_dim,
                  embedding_init=einit.normal_embedding, name="attr")(x[:, 1])
        d = Embed(self.max_depth + 1, self.emb_dim,
                  embedding_init=einit.normal_embedding, name="depth")(depth)
        return t + a + d
