"""Aggregation entry point for the conv layers.

``conv_aggregate`` is the one place a conv asks for its neighbourhood
aggregation; it runs the XLA segment path (``ops.segment.multi_aggregate``).
A hand-written kernel for some platform or shape would be selected here,
from facts the code can observe, so that no conv has to know about it.

Tie semantics of the max/min VJP: the full cotangent is routed to EVERY
edge achieving the extremum (``ops.segment._segment_max_raw``). Known
deviation from the reference: torch_scatter's ``scatter_max`` backward
routes the cotangent to ONE argmax winner, which matters when a segment
holds exactly-equal values (e.g. same-type atom embeddings before the
first nonlinearity) — there our convention sums the cotangent once per
achieving edge. Both agree whenever the achieving value is unique;
duplicate-edge multigraphs would double-count either way (supported
datasets are coalesced).
"""

from __future__ import annotations

from egc_tpu.ops.segment import multi_aggregate


def conv_aggregate(g, x, aggrs, *, include_self: bool = False,
                   symnorm_edge_w=None, symnorm_self_w=None):
    """Aggregate node values ``x`` [N, F] over the in-edges of graph ``g``:
    returns [N, A, F] in the order of ``aggrs``.

    Edges arrive sorted by receiver (``graph.transforms.coalesce_np``);
    ``multi_aggregate`` passes that hint to XLA only when no edge mask is
    given.
    """
    return multi_aggregate(
        x, g.senders, g.receivers, aggrs, edge_mask=g.edge_mask,
        include_self=include_self, symnorm_edge_w=symnorm_edge_w,
        symnorm_self_w=symnorm_self_w, indices_are_sorted=True)
