"""The step programs: one captured CUDA graph per key, replayed.

Twin of the JAX package's compiled step programs: DeviceIO's
(brutefir_tpu/runtime/device_io.py): ``_program`` (:460-466) jits one
step program per key, ``multi_step`` (:561-677) one batch program per
key, run as a ``lax.scan`` over the blocks (``_multi_step_scanned``,
:703-725) or over groups of G blocks (``_multi_step_grouped``,
:727-782), and ``_register_multi`` (:679-701) donates the state; and the
host codec path's (:class:`HostStep`): ``CompiledGraph._program`` /
``step`` (brutefir_tpu/graph/compile.py:105-113, 125-133) and, on a
mesh, ``ShardedGraph._program`` / ``step``
(brutefir_tpu/parallel/mesh.py:253-268) jit one graph step per key.
PyTorch runs eagerly; its counterpart of "one compiled program per key,
replayed" is a ``torch.cuda.CUDAGraph`` of the eager body:

- a key's **first call runs the body eagerly**: a real block, and the
  warm-up that builds and loads the kernels, makes the cuFFT plans, the
  kernels' launch plans and the ``partconv.static_index`` entries, so
  that nothing in the body copies from the host or allocates outside the
  caching allocator afterwards;
- its **second call captures** the body on a side stream
  (``torch.cuda.graph``, ``capture_error_mode="thread_local"``: the
  writer thread fetches earlier blocks meanwhile) and replays it; every
  later call copies its inputs in and replays.

The programs of one DeviceIO read and write one set of tensors at fixed
addresses, :class:`Statics`, the counterpart of the JAX package's donated
arguments: the step state (the overlap-save tails ``prev_in``, the
cascade tails ``eval_prev``, the block counter ``t``; the ring is the
caller's own, written in place as before), ``DeviceIO.dstate`` (delay
windows, subdelay rests, dither ``ptr`` / ``last`` / ``sf``), the
controls, the mute gains and the bank. A call's body ends by copying the
new state into them, and the call returns them as the new state, so a
caller that hands back what it got copies nothing. A caller that hands
in another state (a fresh ``init_state``, an EOF tail after a batch)
gets it copied in first. The read-only arguments are copied only when
the tensor object differs from the last one seen: a new control
snapshot, new mute gains, a bank rebound by an EQ render or a
coefficient swap. An unchanged bank is never copied. The input words
are copied into the program's own buffers on every call. The host
path's programs share the same :class:`Statics` (the step state, and
``ctrl`` and the bank read-only; no ``dstate``: its delay lines, dither
and meters run on the host) and one static input block ``HostStep.x``,
which the engine fills by an asynchronous copy from a pinned staging
buffer before each call.

Outputs outlive the next call: a replay writes the graph's own output
tensors, so each call hands out clones of them (the writer thread
fetches a block after the next one is dispatched).

The kernels' launch counters (``launches`` of ``ops/mac``, ``mac_mix``,
``mac_group``, ``mac_dual``, ``fft_glue``, ``fft_fused``) count Python
calls of their wrappers, which a replay makes none of: each program
records every counter's change over its capture and adds it at every
later replay, so the counts read as if every block ran eagerly.

There is no fallback: a failed capture, or a kernel's launch error while
capturing, raises. Routes that stay eager by design:

- the CPU: the same plumbing (static tensors, copies in and out) with the
  body run eagerly at every call, which is what the CPU tests exercise;
- a mesh whose shards span more than one card (one capture would need
  every card's stream); a mesh on one card is captured like the rest;
- a host-path engine with frequency-domain taps (``Engine.taps``), whose
  taps sync the host in the middle of a block: it makes no
  :class:`HostStep` and runs ``step_impl`` op by op
  (``Engine._dispatch_eager``);
- the stage probe (``runtime/stageprobe.record_block``), which times the
  eager calls of one block.
"""

from __future__ import annotations

import gc
import time
import weakref

import torch

from ..graph.compile import real_dtype, step_impl
from ..ops import fft_fused, fft_glue, mac, mac_dual, mac_group, mac_mix
from ..parallel.mesh import Sharded

# the launch counters a replay keeps true
COUNTERS = (mac.launches, mac_mix.launches, mac_group.launches,
            mac_dual.launches, fft_glue.launches, fft_fused.launches)


def leaves(tree) -> list:
    """The tensors of an argument tree (tensors, None, tuples, named
    tuples, lists, dicts, :class:`Sharded`) in a fixed order; a part that
    several cells of a Sharded share comes once."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Sharded):
        seen, out = set(), []
        for row in tree.parts:
            for p in row:
                if id(p) not in seen:
                    seen.add(id(p))
                    out.append(p)
        return out
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [t for v in tree for t in leaves(v)]


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each of its :func:`leaves`, once a
    tensor, in the same structure (a shared Sharded part stays shared)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Sharded):
        return tree.map(lambda p, i, j: fn(p))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    vals = [tree_map(fn, v) for v in tree]
    if isinstance(tree, list):
        return vals
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


class Slot:
    """Static tensors of one argument tree, refreshed from a caller's
    tree of the same structure. ``owned``: the caller gives its tensors
    up (a state): a leaf is copied in unless it is the static tensor
    itself. Else the caller keeps them (read-only arguments): a leaf is
    copied in only when it is another object than the last one seen."""

    def __init__(self, tree, owned: bool, adopt=None):
        """``adopt(leaf)``: True for a leaf that becomes static as it is,
        uncopied (the ring); every other leaf is cloned."""
        self.owned = owned
        self.tree = tree_map(
            lambda t: t if adopt is not None and adopt(t) else t.clone(),
            tree)
        self.bufs = leaves(self.tree)
        self.srcs = [weakref.ref(t) for t in leaves(tree)]

    def fill(self, tree) -> None:
        src = leaves(tree)
        if len(src) != len(self.bufs):
            raise ValueError(f"program argument has {len(src)} tensors, "
                             f"its static copy {len(self.bufs)}")
        for i, (s, b) in enumerate(zip(src, self.bufs)):
            if s is b or (not self.owned and self.srcs[i]() is s):
                continue
            if s.shape != b.shape or s.dtype != b.dtype:
                raise ValueError(
                    f"program argument {i}: {tuple(s.shape)} {s.dtype}, "
                    f"its static copy {tuple(b.shape)} {b.dtype}")
            b.copy_(s)
            self.srcs[i] = weakref.ref(s)

    def store(self, tree) -> None:
        """Copy a body's new values into the static tensors (inside the
        body: captured with it)."""
        for s, b in zip(leaves(tree), self.bufs):
            if s is not b:
                b.copy_(s)


class Statics:
    """The tensors every program of one DeviceIO or :class:`HostStep`
    reads and writes at fixed addresses: the step state (its ring
    adopted, the rest owned copies), ``dstate`` (DeviceIO's; None on the
    host path), and copies of the read-only ``args`` (DeviceIO's controls,
    gains and bank; the host path's controls and bank)."""

    def __init__(self, state, args, dstate=None):
        ring = {id(t) for t in leaves(state.ring)}
        self.state = Slot(state, True, lambda t: id(t) in ring)
        self.dstate = Slot(dstate, True)
        self.args = Slot(args, False)

    def bind(self, state, args, dstate=None) -> None:
        self.state.fill(state)
        self.dstate.fill(dstate)
        self.args.fill(args)


def capturable(device: torch.device, mesh=None) -> bool:
    """Whether programs on ``device`` (under ``mesh``) are captured: a
    CUDA device, and every shard of a mesh on that one card."""
    if device.type != "cuda":
        return False
    if mesh is None:
        return True
    cards = {(d.type, d.index or 0) for d in mesh.devices.ravel()}
    return cards == {(device.type, device.index or 0)}


def _counts() -> list:
    return [dict(c) for c in COUNTERS]


class Program:
    """One key's program: ``body(words) -> outputs`` reads and writes the
    DeviceIO's :class:`Statics`; the program owns the key's input word
    buffers. Eager at the first call (and at every call unless
    ``capture``), captured at the second, replayed after."""

    def __init__(self, body, device: torch.device, capture: bool):
        self.body = body
        self.device = device
        self.capture = capture
        self.words = None
        self.calls = 0
        self.graph = None
        self.out = None
        self.delta = []          # (counter dict, key, launches a call)
        self.pool_bytes = 0      # device memory the capture reserved
        self.capture_s = 0.0     # host seconds the capture took

    def __call__(self, in_words):
        if self.words is None:
            self.words = Slot(list(in_words), True)
        else:
            self.words.fill(list(in_words))
        words = self.words.tree
        if not self.capture or self.calls == 0:
            out = self.body(words)
        else:
            if self.graph is None:
                self._capture(words)
            else:
                for c, k, n in self.delta:
                    c[k] += n
            self.graph.replay()
            out = tree_map(torch.clone, self.out)
        self.calls += 1
        return out

    def _capture(self, words) -> None:
        """Capture the body into a CUDA graph. Its Python calls count
        their launches once, for this call; the changes are kept for the
        replays. Python's cycle collector is off while capturing
        (``torch.cuda.graph`` collects just before): it could free a
        dropped engine's graph in the middle of the capture, and
        destroying a graph there ends the capture."""
        before = _counts()
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_reserved()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    self.out = self.body(words)
                self.pool_bytes = torch.cuda.memory_reserved() - base
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        self.delta = [(c, k, n - b[k]) for c, b in zip(COUNTERS, before)
                      for k, n in c.items() if n != b[k]]
        self.graph = graph


class HostStep:
    """The host codec path's step programs (``Engine._dispatch_host``):
    one :class:`Program` a key ``(uniform, udelay, xfade)``, the key of
    ``DeviceIO.step`` (the JAX package's ``(uniform, xfade)`` and the
    port's ``uniform_delay``), whose body is ``step_impl`` over the
    :class:`Statics` (the state, ``ctrl`` and the bank) and the static
    input block :attr:`x`. The caller fills ``x`` before each call."""

    def __init__(self, spec, device: torch.device, mesh=None):
        self.spec = spec
        self.device = device
        self.mesh = mesh
        # the block's input [C_in, N], at one address for every program
        self.x = torch.zeros((spec.n_inputs, spec.block_length),
                             dtype=real_dtype(spec), device=device)
        self._statics = None
        self._programs = {}

    def step(self, state, ctrl, bank, uniform=False, udelay=False,
             xfade=False):
        """One block of :attr:`x` -> (state', y [C_out, N]), as
        ``step_impl`` without taps, through the key's program. ``state'``
        is the programs' static state, which the next call reads in
        place."""
        if self._statics is None:
            self._statics = Statics(state, (ctrl, bank))
        else:
            self._statics.bind(state, (ctrl, bank))
        key = (uniform, udelay, xfade)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = Program(self._body(key),
                                                 self.device, self.captures)
        return self._statics.state.tree, prog(())

    def _body(self, key):
        """``step_impl`` over the static tensors: () -> y, the new state
        copied into the static one at the end."""
        S = self._statics
        uniform, udelay, xfade = key

        def body(words):
            st, y = step_impl(self.spec, S.state.tree, *S.args.tree, self.x,
                              uniform=uniform, uniform_delay=udelay,
                              xfade_now=xfade, mesh=self.mesh)
            S.state.store(st)
            return y

        return body

    @property
    def captures(self) -> bool:
        """Whether the programs are captured as CUDA graphs, as
        ``DeviceIO.captures``."""
        return capturable(self.device, self.mesh)

    def programs(self) -> dict:
        """The step programs made so far, by key."""
        return dict(self._programs)
