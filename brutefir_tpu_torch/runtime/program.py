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
buffer before each call; so do the tapped host step's
(:class:`TapStep`), whose segments also share a static host buffer and
a static device input at each tap site.

Outputs outlive the next call: a replay writes the graph's own output
tensors, so each call hands out clones of them (the writer thread
fetches a block after the next one is dispatched).

The kernels' launch counters (``launches`` of ``ops/mac``, ``mac_mix``,
``mac_group``, ``mac_dual``, ``fft_glue``, ``fft_fused``) count Python
calls of their wrappers, which a replay makes none of: each program
records every counter's change over its capture and adds it at every
later replay, so the counts read as if every block ran eagerly.

A host-path engine with frequency-domain taps (``Engine.taps``) hands
its modules host buffers in the middle of a block, as the JAX package's
ordered ``io_callback`` does inside its program (brutefir_tpu/graph/
compile.py:165-178). Its programs (:class:`TapStep`, one
:class:`Segmented` a key) are cut at the S tap sites into S + 1 captured
graphs: segment k ends by copying the planes tap k sees into a pinned
host buffer, the host waits for it, runs the tap's hooks on that buffer
in place, and segment k + 1 starts by copying the buffer into a static
device input, which the rest of the step reads.

Under a mesh (``parallel/mesh.py``, the twin of the JAX package's
``ShardedGraph._program`` and of ``DeviceIO._program`` with in and out
shardings) each shard's work runs on its cell's stream, forked from the
first device's current stream and joined back (``Mesh.cell`` /
``Mesh.join``); a capture begins on the first device's capture stream,
the forks make every cell stream join it and the joins bring them back
before it ends, whether the cells share one card or span several. Across
cards, ``torch.cuda.graph``'s pool covers only the first card: each
other card of the mesh (``Mesh.cards``) allocates into a private
``torch.cuda.MemPool`` of its own while the capture runs, which the
program keeps as long as its graph; each other card's current stream is
a side stream that joins the capture (``CellStreams.capturing``), and a
replay is ordered after, and before, the work on those cards' current
streams (``CellStreams.replaying``).

There is no fallback: a failed capture, or a kernel's launch error while
capturing, raises. Routes that stay eager by design:

- the CPU: the same plumbing (static tensors, copies in and out, the tap
  sites' static buffers) with the body run eagerly at every call, which
  is what the CPU tests exercise;
- the stage probe (``runtime/stageprobe.record_block``), which times the
  eager calls of one block.
"""

from __future__ import annotations

import contextlib
import gc
import time
import weakref

import numpy as np
import torch

from ..graph.compile import real_dtype, step_impl
from ..ops import fft_fused, fft_glue, mac, mac_dual, mac_group, mac_mix
from ..parallel.mesh import Sharded
from .tracing import RECORDER as REC

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
    CUDA device, and every shard of a mesh on a card (one or several)."""
    if device.type != "cuda":
        return False
    return mesh is None or all(d.type == "cuda"
                               for d in mesh.devices.ravel())


def _spans(mesh) -> bool:
    """Whether ``mesh`` spans more than one card."""
    return mesh is not None and len(mesh.cards()) > 1


def _counts() -> list:
    return [dict(c) for c in COUNTERS]


def _delta(before: list) -> list:
    """Each launch counter's change since ``before``: (counter dict,
    key, launches)."""
    return [(c, k, n - b.get(k, 0)) for c, b in zip(COUNTERS, before)
            for k, n in c.items() if n != b.get(k, 0)]


def _capturing(device: torch.device, capture, mesh=None, key=None):
    """Run ``capture()`` on synchronised cards (``device``, and under a
    ``mesh`` every card it spans) with the allocator's cache emptied and
    Python's cycle collector off (``torch.cuda.graph`` collects just
    before; a collection in the middle could free a dropped engine's
    graph, and destroying a graph there ends the capture). Each card
    other than ``device`` allocates into a private ``MemPool`` of its own
    meanwhile. Returns (its result, the device bytes the capture reserved
    by card, its host seconds, the private pools). ``key``: the program's
    key, in the name of its ``program.capture`` span."""
    sp = REC.on and REC.begin(f"program.capture {key}")
    t0 = time.perf_counter()
    cards = [device] if mesh is None else mesh.cards()
    collecting = gc.isenabled()
    gc.disable()
    try:
        base = {}
        for card in cards:
            with torch.cuda.device(card):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base[card] = torch.cuda.memory_reserved(card)
        pools = []
        for card in cards[1:]:
            with torch.cuda.device(card):
                pools.append(torch.cuda.MemPool())
        with contextlib.ExitStack() as stack:
            for card, pool in zip(cards[1:], pools):
                stack.enter_context(torch.cuda.use_mem_pool(pool,
                                                            device=card))
            with torch.cuda.device(device):
                out = capture()
        reserved = {str(card): torch.cuda.memory_reserved(card) - base[card]
                    for card in cards}
    finally:
        if collecting:
            gc.enable()
        if sp:
            REC.end(sp)
    return out, reserved, time.perf_counter() - t0, pools


class Program:
    """One key's program: ``body(words) -> outputs`` reads and writes the
    DeviceIO's :class:`Statics`; the program owns the key's input word
    buffers. Eager at the first call (and at every call unless
    ``capture``), captured at the second, replayed after. ``mesh``: the
    step's mesh, whose cell streams the capture takes in and whose cards
    other than the first get a private pool each (``_capturing``)."""

    def __init__(self, body, device: torch.device, capture: bool,
                 mesh=None, key=None):
        self.body = body
        self.device = device
        self.capture = capture
        self.mesh = mesh
        self.key = key           # the owner's key, for the capture's span
        self.words = None
        self.calls = 0
        self.graph = None
        self.out = None
        self.delta = []          # (counter dict, key, launches a call)
        self.pool_bytes = 0      # device memory the capture reserved
        self.card_pool_bytes = {}   # the same by card
        self.pools = []          # the private pools of the other cards
        self.capture_s = 0.0     # host seconds the capture took

    def __call__(self, in_words, sp=False):
        """The outputs of one call on ``in_words``. ``sp``: the caller's
        open ``bind`` span (its statics bound), which goes on over the
        word slots."""
        sp = sp or (REC.on and REC.begin("bind"))
        if self.words is None:
            self.words = Slot(list(in_words), True)
        else:
            self.words.fill(list(in_words))
        words = self.words.tree
        if not self.capture or self.calls == 0:
            sp = sp and REC.next(sp, "eager")
            out = self.body(words)
        else:
            if self.graph is None:
                if sp:
                    REC.end(sp)
                self._capture(words)
                sp = REC.on and REC.begin("replay")
            else:
                for c, k, n in self.delta:
                    c[k] += n
                sp = sp and REC.next(sp, "replay")
            with (self.mesh.streams.replaying() if _spans(self.mesh)
                  else contextlib.nullcontext()):
                self.graph.replay()
            sp = sp and REC.next(sp, "clone")
            out = tree_map(torch.clone, self.out)
        if sp:
            REC.end(sp)
        self.calls += 1
        return out

    def _capture(self, words) -> None:
        """Capture the body into a CUDA graph (``_capturing``), across
        cards with each other card's current stream inside the capture
        (``CellStreams.capturing``). Its Python calls count their launches
        once, for this call; the changes are kept for the replays."""
        before = _counts()
        spans = _spans(self.mesh)

        def capture():
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                with (self.mesh.streams.capturing() if spans
                      else contextlib.nullcontext()):
                    self.out = self.body(words)
            return graph

        graph, reserved, self.capture_s, self.pools = _capturing(
            self.device, capture, self.mesh, self.key)
        self.card_pool_bytes = reserved
        self.pool_bytes = sum(reserved.values())
        self.delta = _delta(before)
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
        ``step_impl``, through the key's program. ``state'`` is the
        programs' static state, which the next call reads in place."""
        if self._statics is None:
            self._statics = Statics(state, (ctrl, bank))
        else:
            self._statics.bind(state, (ctrl, bank))
        key = (uniform, udelay, xfade)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._program(key)
        return self._statics.state.tree, prog(())

    def _program(self, key):
        return Program(self._body(key), self.device, self.captures,
                       self.mesh, key)

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
        ``DeviceIO.captures``: on the card, on a mesh too."""
        return capturable(self.device, self.mesh)

    def programs(self) -> dict:
        """The step programs made so far, by key."""
        return dict(self._programs)


class Site:
    """One tap site of the tapped step: the hook ``kind`` and the ids
    ``idx`` of its rows; ``buf``, the host buffer of the planes the tap
    sees (pinned on the card: its segment's last copy fills it, the
    hooks mutate it, the next segment's first copy reads it); ``inp``,
    the static device input of the next segment; ``ready``, the event
    the host waits on before reading ``buf`` (None on the CPU)."""

    def __init__(self, kind: str, idx, planes: torch.Tensor):
        self.kind = kind
        self.idx = idx
        cuda = planes.device.type == "cuda"
        self.buf = torch.empty(planes.shape, dtype=planes.dtype,
                               pin_memory=cuda)
        self.inp = torch.empty_like(planes,
                                    memory_format=torch.contiguous_format)
        self.ready = torch.cuda.Event() if cuda else None


class TapStep(HostStep):
    """The tapped host step's programs: :class:`HostStep` for an engine
    with frequency-domain taps, the twin of the JAX package's
    ``CompiledGraph._program`` / ``step`` with ``taps`` set
    (brutefir_tpu/graph/compile.py:105-133, its taps ordered host
    callbacks at :165-178). One :class:`Segmented` program a key, on the
    same :class:`Statics` and static input block :attr:`x`; ``taps`` is
    the engine's (``Engine._make_freqd_tap``: kind -> ``tap(planes, idx,
    ready=None, out=None)``). Never on a mesh: taps drop an automatic
    mesh and an explicit one refuses them (``Engine.attach_logic``).

    Every key's step reaches the same S tap sites in one fixed order
    (``input_freqd``; each stage's ``pre_convolve`` and
    ``post_convolve``; ``output_freqd``; only the kinds some module
    hooks), kept in :attr:`sites` and shared by the keys' programs, one
    key's block never interleaving with another's."""

    def __init__(self, spec, device: torch.device, taps: dict):
        super().__init__(spec, device)
        self.taps = taps
        self.sites = []

    def _program(self, key):
        return Segmented(self, key, self.captures)

    def _site(self, k: int, kind: str, planes: torch.Tensor, idx) -> Site:
        """Tap site ``k``, made at its first call."""
        if k == len(self.sites):
            self.sites.append(Site(kind, idx, planes))
        site = self.sites[k]
        if (site.kind != kind or site.buf.shape != planes.shape
                or site.buf.dtype != planes.dtype
                or not np.array_equal(site.idx, idx)):
            raise ValueError(
                f"tap site {k}: {kind} {tuple(planes.shape)} "
                f"{planes.dtype}, its static buffers {site.kind} "
                f"{tuple(site.buf.shape)} {site.buf.dtype}")
        return site

    def segments(self, key, boundary):
        """One block of ``step_impl`` over the static tensors with every
        tap site k a segment boundary: the planes tap k sees are copied
        into ``sites[k].buf`` (segment k's last copy), ``boundary(site)``
        runs, and ``buf`` is copied into ``sites[k].inp`` (segment k +
        1's first), which the step reads on. Returns y; the new state is
        copied into the static one at the end."""
        S = self._statics
        uniform, udelay, xfade = key
        n = 0

        def stub(kind):
            def tap(planes, idx):
                nonlocal n
                site = self._site(n, kind, planes, idx)
                n += 1
                site.buf.copy_(planes, non_blocking=True)
                boundary(site)
                return site.inp.copy_(site.buf, non_blocking=True)
            return tap

        st, y = step_impl(self.spec, S.state.tree, *S.args.tree, self.x,
                          uniform=uniform, uniform_delay=udelay,
                          xfade_now=xfade,
                          taps={kind: stub(kind) for kind in self.taps})
        S.state.store(st)
        return y

    def tap(self, site: Site) -> None:
        """A site's host side: the engine's tap of its kind on ``buf`` in
        place, once the copy into it (queued on the current stream) has
        landed: the fetch, the hooks in module order, the planes back."""
        if site.ready is not None:
            site.ready.record()
        self.taps[site.kind](site.buf, site.idx, site.ready, site.buf)


class Segmented:
    """One key's program of a :class:`TapStep`: S + 1 CUDA graphs, one
    segment of the step between each pair of tap sites, sharing one
    private memory pool (tensors live across the boundaries, and the
    segments are always replayed in capture order). Eager at the first
    call (``TapStep.segments`` with the real taps; at every call unless
    ``capture``), captured at the second, then replayed: segment 0, tap
    0's host side, segment 1, ..., segment S; the output is cloned, as
    :class:`Program` clones its outputs. A replay adds each segment's
    launch counts as it replays it."""

    def __init__(self, owner: TapStep, key, capture: bool):
        self.owner = owner
        self.key = key
        self.capture = capture
        self.calls = 0
        self.graph = None        # the segments' graphs, once captured
        self.out = None
        self.delta = []          # a segment: (counter dict, key, launches)
        self.pool_bytes = 0      # device memory the capture reserved
        self.card_pool_bytes = {}   # the same by card
        self.capture_s = 0.0     # host seconds the capture took
        self._stream = None

    @property
    def segments(self) -> int:
        """S + 1, for the S tap sites of the step."""
        return len(self.owner.sites) + 1

    def __call__(self, in_words=()):
        owner = self.owner
        if not self.capture or self.calls == 0:
            out = owner.segments(self.key, owner.tap)
        else:
            replayed = self.graph is not None
            if not replayed:
                self._capture()
            for k, graph in enumerate(self.graph):
                if replayed:
                    for c, name, n in self.delta[k]:
                        c[name] += n
                graph.replay()
                if k < len(owner.sites):
                    owner.tap(owner.sites[k])
            out = tree_map(torch.clone, self.out)
        self.calls += 1
        return out

    def _capture(self) -> None:
        """Capture the segments (``_capturing``) on a side stream with
        ``capture_begin`` / ``capture_end``, which, unlike
        ``torch.cuda.graph``, can end in the middle of ``step_impl``: each
        tap site ends one graph and begins the next. The Python calls
        count their launches once, for this call; each segment's changes
        are kept for its replays."""
        graphs, delta, marks = [], [], []
        pool = torch.cuda.graph_pool_handle()

        def begin():
            graphs.append(torch.cuda.CUDAGraph())
            marks.append(_counts())
            graphs[-1].capture_begin(pool=pool,
                                     capture_error_mode="thread_local")

        def end():
            graphs[-1].capture_end()
            delta.append(_delta(marks[-1]))

        def boundary(site):
            end()
            begin()

        def capture():
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            with torch.cuda.stream(self._stream):
                begin()
                try:
                    out = self.owner.segments(self.key, boundary)
                except BaseException:
                    # close the open capture, then raise what broke it
                    try:
                        graphs[-1].capture_end()
                    except RuntimeError:
                        pass
                    raise
                end()
            return out

        self.out, reserved, self.capture_s, _ = _capturing(
            self.owner.device, capture, key=self.key)
        self.card_pool_bytes = reserved
        self.pool_bytes = sum(reserved.values())
        self.delta = delta
        self.graph = tuple(graphs)
