"""egc_tpu: a graph neural network framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the EGC reference
implementation (shyam196/egc — "Do We Need Anisotropic Graph Neural
Networks?", ICLR 2022), run on the GPU:

- Static-shape, pad-and-mask graph batching (XLA compiles one program per
  shape).
- Multi-aggregator segment reductions (sum/mean/min/max/var/std/symnorm)
  as one primitive — the paper's "aggregator fusion".
- The full EGC model family (EGC-S / EGC-M) plus GCN/GAT/GATv2/GIN/SAGE/
  towered-MPNN/PNA baselines and heterogeneous RGCN/REGC layers.
- Batched mini-graph training (zinc/cifar/mol/code) and full-graph
  transductive training (arxiv/mag) over one codebase.
- Multi-chip scaling via `jax.sharding.Mesh`: data parallelism for batched
  tasks and graph partitioning + halo exchange for full-graph tasks.
- An experiment harness (configs, hyperparameter search, early stopping,
  seeded final repeats, checkpointing) mirroring the reference's
  exptune/ray.tune surface without Ray.
"""

__version__ = "0.1.0"

from egc_tpu.graph.structure import Graph  # noqa: F401
