"""Static graph description for the per-block step (numpy only).

Twin of :mod:`brutefir_tpu.graph.spec` (the port imports nothing of the
JAX package). Only *structure* lives here;
everything runtime-controllable is a tensor in ``StepCtrl``.

The port keeps persistent spectra in the flat ``[.., 2, N]`` layout: the
lane-tiled ``[.., 2, N/128, 128]`` form of the JAX package exists only for
TPU tiles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass(frozen=True)
class StageSpec:
    """One topological stage of the filter DAG (filters computable together)."""

    idx: np.ndarray            # [Fs] int32 global filter indices
    casc_local: np.ndarray     # positions within idx that have filter inputs
    casc_slots: np.ndarray     # rows in the eval_prev state for those filters
    any_crossfade: bool        # static: any filter in this stage may crossfade


@dataclass(frozen=True)
class GraphSpec:
    block_length: int          # N (partition length, samples per block)
    n_blocks: int              # B (number of partitions in the ring)
    n_inputs: int              # virtual input channels
    n_outputs: int             # virtual output channels
    n_filters: int
    stages: tuple              # tuple[StageSpec]
    n_casc: int                # filters with filter inputs (eval_prev rows)
    any_crossfade: bool
    real_dtype: np.dtype = np.dtype(np.float32)   # float64: float_bits: 64
    powersave: bool = False    # trace the analog-powersave input gate

    @property
    def n_bins(self) -> int:
        """Packed spectral bins (Nyquist folded into bin 0)."""
        return self.block_length

    @property
    def tileable(self) -> bool:
        """Whether the JAX package can keep this shape's spectra in its
        lane-tiled layout (spec.py:68), which its grouped dispatch
        requires; the port's layout is flat either way."""
        return self.n_bins % 128 == 0

    @property
    def single_full_stage(self) -> bool:
        """One stage holding every filter in order, with no filter
        inputs: the graph the fused MAC + mix paths take."""
        return (len(self.stages) == 1
                and self.stages[0].casc_local.size == 0
                and np.array_equal(self.stages[0].idx,
                                   np.arange(self.n_filters)))

    def ring_shape(self) -> tuple:
        return (self.n_filters, self.n_blocks, 2, self.n_bins)


def build_graph_spec(
    block_length: int,
    n_blocks: int,
    n_inputs: int,
    n_outputs: int,
    filter_inputs: Sequence[Sequence[int]],
    crossfade_flags: Sequence[bool],
    real_dtype=np.float32,
    powersave: bool = False,
) -> GraphSpec:
    """Topologically stage the filter DAG.

    ``filter_inputs[f]`` lists the filters feeding filter f (from_filters
    edges). Raises ValueError on a cycle (config validation already
    rejects them, mirroring `bfconf.c:2032-2048`).
    """
    F = len(filter_inputs)
    # iterative longest-path depths in Kahn order (no recursion limit on
    # deep from_filters chains)
    indeg = [len(filter_inputs[f]) for f in range(F)]
    consumers = [[] for _ in range(F)]
    for f in range(F):
        for u in filter_inputs[f]:
            consumers[u].append(f)
    depth = [0] * F
    ready = [f for f in range(F) if indeg[f] == 0]
    seen = 0
    while ready:
        u = ready.pop()
        seen += 1
        for v in consumers[u]:
            depth[v] = max(depth[v], depth[u] + 1)
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    if seen != F:
        raise ValueError("cycle in filter graph")

    n_stages = (max(depth) + 1) if F else 0
    casc_slot = {}
    for f in range(F):
        if filter_inputs[f]:
            casc_slot[f] = len(casc_slot)

    stages: List[StageSpec] = []
    for s in range(n_stages):
        idx = np.array([f for f in range(F) if depth[f] == s], dtype=np.int32)
        casc_local = np.array(
            [i for i, f in enumerate(idx) if filter_inputs[f]], dtype=np.int32)
        casc_slots = np.array(
            [casc_slot[int(f)] for f in idx[casc_local]], dtype=np.int32)
        any_xf = any(crossfade_flags[int(f)] for f in idx)
        stages.append(StageSpec(idx, casc_local, casc_slots, any_xf))

    return GraphSpec(
        block_length=block_length,
        n_blocks=n_blocks,
        n_inputs=n_inputs,
        n_outputs=n_outputs,
        n_filters=F,
        stages=tuple(stages),
        n_casc=len(casc_slot),
        any_crossfade=any(crossfade_flags),
        real_dtype=np.dtype(real_dtype),
        powersave=powersave,
    )
