"""Multi-device sharding of the block step: one process, a grid of shards.

Torch twin of :mod:`brutefir_tpu.parallel.mesh`. The reference scales by
forking filter processes (`bfconf.c:2227-2318`); the JAX package shards
one jitted program over an ('f', 'sp') device mesh and lets XLA insert the
collectives. Here one process drives every shard:

* **bin parallelism** ``sp``: the frequency-bin axis K of the spectra
  ring, the coefficient bank and the MAC is embarrassingly parallel; each
  shard MACs its bins, and the output spectra are concatenated over
  ``sp`` before the inverse transform (the JAX package's all-gather);
* **filter parallelism** ``f``: the filter axis of the ring, the MAC and
  the per-filter controls; the output mix contracts over F, so the fused
  MAC + mix's partial sums of the ``f`` shards are added on the first
  device in a fixed order (the JAX package's psum over 'f').

A :class:`Mesh` is a plain object: an ``[f, sp]`` array of
``torch.device`` (repeats allowed: several shards may share one device,
``cpu`` in the tests, the one card of a single-card host) and a ``shape``
dict, as ``jax.sharding.Mesh`` has. Shard ``(i, j)`` holds filter rows
``rows(F)[i]`` and bins ``bins(K)[j]``: contiguous ranges of ceil(F / f)
filters and ceil(K / sp) bins (the last ones shorter where the axis does
not divide, as XLA pads an uneven split). Each shard owns contiguous
tensors on its device (a :class:`Sharded`): its ring ``[F/f, B, 2,
K/sp]``, its bin shard of the bank ``[E, B, 2, K/sp]`` and its rows of the
per-filter controls. The ring is never a view of one big tensor: a bin
shard of ``[F, B, 2, K]`` is not contiguous.

The transforms, the sample codecs, the input mix and the output half run
once, on the mesh's first device (the JAX package replicates them on
every device, which gives the same values): the mixed input spectra are
split to the shards, and the shards' outputs gathered back.

Cascade (from_filters) intermediates stay on the first device, as the
JAX package pins them replicated: a stage subset runs the per-shard MAC
on the rows each shard holds (``ops/mac_shard.py``), and its spectra are
gathered to the first device for the next stage's mix.

On the card each shard runs on a stream of its own (:class:`CellStreams`),
the nearest twin of the JAX package's shards running at once, one device
each: a cell's work (its copies in, its kernel, the partial it hands
back) runs inside ``Mesh.cell(i, j)``, whose stream waits on the first
device's current stream when the cell begins, and ``Mesh.join()`` makes
the first device's current stream wait on every cell that ran before the
first device reads a result or goes on (every per-cell loop ends with
it). Cells on one card share nothing they write (each owns its ring
part), only read-only parts such as a bank bin shard. A mesh on one card
runs the same forks and joins as a mesh across cards, so the step
programs (``runtime/program.py``) capture both alike: the cell streams
join the capture through their forks and are joined back before it
ends, and the cards other than the first allocate into a private pool
of their own while it runs (:meth:`Mesh.cards`). On the CPU a cell and
a join do nothing: the shards run one after another.

The JAX package's lane-tiled 5-d ring layout is a TPU matter: the port's
ring is flat, so its sharding has one layout.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..errors import BFError, BF_EXIT_INVALID_CONFIG


class Mesh:
    """An ('f', 'sp') grid of devices: ``devices`` [f, sp] (an object
    array of ``torch.device``), ``shape`` ``{"f": f, "sp": sp}``."""

    axis_names = ("f", "sp")

    def __init__(self, devices):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for ij in np.ndindex(src.shape):
            arr[ij] = torch.device(src[ij])
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError(f"a mesh is a non-empty [f, sp] grid of "
                             f"devices, got shape {arr.shape}")
        self.devices = arr
        self.shape = {"f": arr.shape[0], "sp": arr.shape[1]}
        # the cells' streams on the card; None on the CPU
        self.streams = (CellStreams(self) if arr[0, 0].type == "cuda"
                        else None)

    @property
    def first(self) -> torch.device:
        """The device of shard (0, 0): where the transforms, the codecs
        and the mixes run, and where shard outputs are gathered."""
        return self.devices[0, 0]

    def cells(self):
        """(i, j, device) of every shard, 'f' outer, 'sp' inner."""
        for i in range(self.shape["f"]):
            for j in range(self.shape["sp"]):
                yield i, j, self.devices[i, j]

    def cards(self) -> list:
        """The distinct devices of the mesh, the first device first: the
        cards it spans (cells may share one)."""
        out = []
        for d in [self.first] + list(self.devices.ravel()):
            if d not in out:
                out.append(d)
        return out

    def cell(self, i: int, j: int):
        """The context of cell (i, j)'s work: on the card its stream
        (:meth:`CellStreams.cell`), on the CPU nothing."""
        return (contextlib.nullcontext() if self.streams is None
                else self.streams.cell(i, j))

    def join(self) -> None:
        """The first device waits on every cell that ran since the last
        join (:meth:`CellStreams.join`); on the CPU nothing."""
        if self.streams is not None:
            self.streams.join()

    def rows(self, F: int) -> list:
        """Filter rows of each 'f' shard: [(lo, hi)] * f."""
        return _bounds(F, self.shape["f"])

    def bins(self, K: int) -> list:
        """Bins of each 'sp' shard: [(lo, hi)] * sp."""
        return _bounds(K, self.shape["sp"])

    def __repr__(self):
        return (f"Mesh(f={self.shape['f']}, sp={self.shape['sp']}, "
                f"devices={[str(d) for d in self.devices.ravel()]})")


class CellStreams:
    """The cells' streams of a mesh on the card. Cell (i, j) runs its work
    on a stream of its own on its device, made at its first use:

    - :meth:`cell` forks it: the cell's stream waits on the first
      device's current stream (and, on another card, on that card's
      current stream, which carries the mesh's set-up and the statics'
      copies onto that card) and is the current stream of its device
      while the work is queued;
    - :meth:`join` makes the first device's current stream (and each
      other card's current stream) wait on every cell stream forked
      since the last join. A per-cell loop joins before the first device
      reads what the cells made, and before the tensors the cells read
      can be freed: the first device's next allocation then waits on
      their reads.

    A capture (``runtime/program.py``) runs on the first device's current
    stream: the forks make the cell streams join it, the joins bring them
    back before it ends. Across cards, :meth:`capturing` and
    :meth:`replaying` keep the other cards' current streams inside the
    capture and ordered with each replay."""

    def __init__(self, mesh: "Mesh"):
        self.mesh = mesh
        self.streams = {}        # (i, j) -> the cell's stream
        self.forked = {}         # cells forked since the last join
        self._side = {}          # card -> its stream while capturing

    @contextlib.contextmanager
    def cell(self, i: int, j: int):
        dev = self.mesh.devices[i, j]
        s = self.streams.get((i, j))
        if s is None:
            s = self.streams[(i, j)] = torch.cuda.Stream(device=dev)
        s.wait_stream(torch.cuda.current_stream(self.mesh.first))
        if dev != self.mesh.first:
            s.wait_stream(torch.cuda.current_stream(dev))
        self.forked[(i, j)] = s
        with torch.cuda.stream(s):
            yield

    def join(self) -> None:
        first = torch.cuda.current_stream(self.mesh.first)
        for (i, j), s in self.forked.items():
            first.wait_stream(s)
            dev = self.mesh.devices[i, j]
            if dev != self.mesh.first:
                torch.cuda.current_stream(dev).wait_stream(s)
        self.forked.clear()

    @contextlib.contextmanager
    def capturing(self):
        """Around a capture's body on the first device's current stream:
        each other card's current stream is a side stream of its own
        that forks from the capture at entry and is joined back at exit,
        so every copy and wait across cards stays inside the capture."""
        first = self.mesh.first
        cards = self.mesh.cards()[1:]
        prev = []
        for card in cards:
            s = self._side.get(card)
            if s is None:
                s = self._side[card] = torch.cuda.Stream(device=card)
            s.wait_stream(torch.cuda.current_stream(first))
            with torch.cuda.device(card):
                prev.append(torch.cuda.current_stream(card))
                torch.cuda.set_stream(s)
        try:
            yield
        finally:
            for card, p in zip(cards, prev):
                torch.cuda.current_stream(first).wait_stream(
                    self._side[card])
                with torch.cuda.device(card):
                    torch.cuda.set_stream(p)

    @contextlib.contextmanager
    def replaying(self):
        """Around a replay on the first device's current stream: it waits
        on each other card's current stream, and they on it after, as the
        forks and joins of a block's cells order the eager form."""
        first = torch.cuda.current_stream(self.mesh.first)
        cards = self.mesh.cards()[1:]
        for card in cards:
            first.wait_stream(torch.cuda.current_stream(card))
        yield
        for card in cards:
            torch.cuda.current_stream(card).wait_stream(first)


def _bounds(n: int, parts: int) -> list:
    step = -(-n // parts)
    return [(min(p * step, n), min((p + 1) * step, n)) for p in range(parts)]


def default_devices(device=None) -> list:
    """The devices an automatic mesh spreads over: every visible card for
    an engine on ``cuda`` (``cuda:0 .. cuda:n-1``), else the one
    ``device`` (an engine on the CPU or on a named card runs unsharded
    unless given a mesh)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return [device]
    return [torch.device(f"cuda:{k}")
            for k in range(torch.cuda.device_count())]


def make_mesh(devices=None, f_axis: int = 1, sp_axis: int = None) -> Mesh:
    """Build an ('f', 'sp') mesh over ``devices`` (default: every visible
    card). A device may repeat: its shards then share it."""
    devices = list(devices if devices is not None else default_devices())
    n = len(devices)
    if f_axis < 1 or f_axis > n or n % f_axis != 0:
        raise ValueError(
            f"f_axis={f_axis} must be a positive divisor of the device "
            f"count ({n}); got {n} device(s). Pass fewer devices or a "
            f"compatible f_axis (e.g. f_axis=1).")
    if sp_axis is None:
        sp_axis = n // f_axis
    if f_axis * sp_axis != n:
        raise ValueError(f"mesh {f_axis}x{sp_axis} != {n} devices")
    arr = np.empty((f_axis, sp_axis), dtype=object)
    for k, d in enumerate(devices):
        arr[k // sp_axis, k % sp_axis] = torch.device(d)
    return Mesh(arr)


def available(n_bins: int, dtype) -> bool:
    """The JAX package's ``pallas_available`` (pallas_mac.py:1466-1468):
    float32 with lane-aligned tiles, K % 128 == 0 and K >= 256."""
    return (np.dtype(dtype) == np.float32 and n_bins % 128 == 0
            and n_bins >= 256)


def shardable(mesh, n_filters: int, n_bins: int, dtype) -> bool:
    """The JAX package's ``pallas_shardable`` (pallas_mac.py:1457-1463):
    the filters divide by f, the bins by sp, and each bin shard is
    ``available``. The card would take more; the rule is kept so that a
    config takes the same mesh and the same routes, and so the same
    summation order, in both packages. Where it fails the JAX package
    runs its dense MAC; the port runs its same kernels per shard on the
    mesh (the stage loop's ``mac_shard``, the mix outside)."""
    f = mesh.shape.get("f", 1)
    sp = mesh.shape.get("sp", 1)
    return (n_filters % f == 0 and n_bins % sp == 0
            and available(n_bins // sp, dtype))


def auto_mesh(n_filters: int, n_bins: int, real_dtype, devices=None,
              env=None, f_pref: int = 0):
    """Pick an ('f', 'sp') mesh for the visible devices, as the JAX
    package's ``auto_mesh`` does (parallel/mesh.py:53-174), line for line.

    ``env`` overrides the BRUTEFIR_TPU_MESH environment variable:
    "off"/"none"/"0"/"1" -> no mesh; "FxS" -> those axes (a malformed or
    too large value is a typed config error, checked before any device
    query); "auto"/unset -> prefer pure bin parallelism (sp = n), then
    mixed f x sp meshes, preferring shapes where the kernel route
    survives (``shardable``), shrinking the device count only when
    nothing divides. ``f_pref`` > 0 asks for manual ``process:``
    placement: 'f' as close to the process count as the devices allow,
    the filter-count rule waived (the engine pads the filter axis).
    ``devices`` defaults to every visible card. Returns None for one
    device, when disabled, or when no shape is usable."""
    setting = (os.environ.get("BRUTEFIR_TPU_MESH", "auto")
               if env is None else env)
    setting = (setting or "auto").strip().lower()
    if setting in ("off", "none", "0", "1"):
        return None
    if setting != "auto":
        f_s, _, s_s = setting.partition("x")
        try:
            f = int(f_s)
            sp = int(s_s) if s_s else 0   # 0 = fill from device count
            if f < 1 or sp < 0:
                raise ValueError
        except ValueError:
            raise BFError(
                f"BRUTEFIR_TPU_MESH={setting!r}: expected 'off', 'auto', "
                "or FxS (e.g. '2x4')",
                exit_code=BF_EXIT_INVALID_CONFIG) from None
        devices = list(devices if devices is not None
                       else default_devices())
        n = len(devices)
        if sp == 0:
            sp = max(1, n // f)
        if f * sp > n:
            raise BFError(
                f"BRUTEFIR_TPU_MESH={setting!r} needs {f * sp} devices, "
                f"only {n} visible",
                exit_code=BF_EXIT_INVALID_CONFIG)
        if f * sp <= 1:
            return None
        return make_mesh(devices[: f * sp], f_axis=f, sp_axis=sp)
    devices = list(devices if devices is not None else default_devices())
    n = len(devices)
    if n <= 1:
        return None

    def usable(f, sp, waive_filters=False):
        if not waive_filters and f > 1 and n_filters % f != 0:
            return 0
        trial = type("M", (), {"shape": {"f": f, "sp": sp}})()
        if (available(n_bins, real_dtype)
                and shardable(trial, n_filters, n_bins, real_dtype)):
            return 2                              # kernel route survives
        if n_bins % sp == 0:
            return 1                              # per-shard stage loop
        return 0

    if f_pref > 0:
        # manual placement: the process count on 'f' as closely as the
        # devices allow; among f <= f_pref, kernel-route shapes first,
        # then the largest f, then the most devices
        best = None
        for total in range(n, 1, -1):
            divs = [d for d in range(1, total + 1) if total % d == 0]
            for f in sorted((d for d in divs if d <= f_pref),
                            key=lambda d: -d):
                sp = total // f
                score = usable(f, sp, waive_filters=True)
                if score and (best is None or (score, f) > best[:2]):
                    best = (score, f, total)
            if best is not None and best[0] == 2:
                break
        if best is not None:
            _, f, total = best
            return make_mesh(devices[:total], f_axis=f, sp_axis=total // f)
        # nothing honours the pins: the auto heuristic (the engine warns
        # that placement has no effect on an f = 1 mesh)

    # candidate device counts, largest first; per count, sp-pure first,
    # then growing f
    for total in range(n, 1, -1):
        best = None
        for f in [d for d in range(1, total + 1) if total % d == 0]:
            sp = total // f
            score = usable(f, sp)
            if score and (best is None or score > best[0]):
                best = (score, f, sp)
        if best is not None:
            _, f, sp = best
            return make_mesh(devices[:total], f_axis=f, sp_axis=sp)
    return None


# --- the layout: split and gather (the JAX package's step_shardings) -------

class Sharded:
    """A tensor split over a mesh: ``parts[i][j]`` on ``mesh.devices[i,
    j]``, contiguous, holding rows ``mesh.rows(n)[i]`` of ``row_axis`` and
    bins ``mesh.bins(n)[j]`` of ``bin_axis`` (None: that axis is whole).
    ``shape`` is the whole tensor's. Cells on one device that hold the
    same slice share one tensor (a bank's bin shard, a control's rows)."""

    __slots__ = ("mesh", "parts", "row_axis", "bin_axis", "shape", "dtype")

    def __init__(self, mesh, parts, row_axis, bin_axis, shape, dtype):
        self.mesh = mesh
        self.parts = parts
        self.row_axis = row_axis
        self.bin_axis = bin_axis
        self.shape = tuple(shape)
        self.dtype = dtype

    def ranges(self, i: int, j: int):
        """((lo, hi) of the rows or None, (lo, hi) of the bins or None)
        of cell (i, j)."""
        r = (None if self.row_axis is None
             else self.mesh.rows(self.shape[self.row_axis])[i])
        b = (None if self.bin_axis is None
             else self.mesh.bins(self.shape[self.bin_axis])[j])
        return r, b

    def map(self, fn) -> "Sharded":
        """A new Sharded of ``fn(part, i, j)`` over the cells; a part
        shared by several cells is mapped once and stays shared."""
        done = {}
        parts = []
        for i in range(self.mesh.shape["f"]):
            row = []
            for j in range(self.mesh.shape["sp"]):
                p = self.parts[i][j]
                if id(p) not in done:
                    done[id(p)] = fn(p, i, j)
                row.append(done[id(p)])
            parts.append(row)
        first = parts[0][0]
        return Sharded(self.mesh, parts, self.row_axis, self.bin_axis,
                       self.shape, first.dtype)


def to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: itself where it is there already (no copy, no
    sync), else an asynchronous copy from the current streams."""
    return x if x.device == device else x.to(device, non_blocking=True)


def _cell_slice(x, row_axis, bin_axis, r, b):
    if row_axis is not None:
        x = x.narrow(row_axis, r[0], r[1] - r[0])
    if bin_axis is not None:
        x = x.narrow(bin_axis, b[0], b[1] - b[0])
    return x


def split(mesh: Mesh, x: torch.Tensor, row_axis=None,
          bin_axis=None) -> Sharded:
    """``x`` split over ``mesh``: rows of ``row_axis`` over 'f', bins of
    ``bin_axis`` over 'sp' (either None: whole), each part a contiguous
    tensor on its cell's device, made in the cell's context (a part that
    several cells on one device share, in the first one's)."""
    memo = {}
    parts = []
    for i in range(mesh.shape["f"]):
        row = []
        for j in range(mesh.shape["sp"]):
            dev = mesh.devices[i, j]
            key = (str(dev), i if row_axis is not None else None,
                   j if bin_axis is not None else None)
            if key not in memo:
                r = (None if row_axis is None
                     else mesh.rows(x.shape[row_axis])[i])
                b = (None if bin_axis is None
                     else mesh.bins(x.shape[bin_axis])[j])
                with mesh.cell(i, j):
                    memo[key] = to_device(_cell_slice(
                        x, row_axis, bin_axis, r, b), dev).contiguous()
            row.append(memo[key])
        parts.append(row)
    mesh.join()
    return Sharded(mesh, parts, row_axis, bin_axis, x.shape, x.dtype)


def zeros(mesh: Mesh, shape, dtype, row_axis=None, bin_axis=None) -> Sharded:
    """A Sharded of zeros, each cell's part its own tensor on its device
    (a ring: written in place per cell)."""
    parts = []
    for i in range(mesh.shape["f"]):
        row = []
        for j in range(mesh.shape["sp"]):
            pshape = list(shape)
            if row_axis is not None:
                lo, hi = mesh.rows(shape[row_axis])[i]
                pshape[row_axis] = hi - lo
            if bin_axis is not None:
                lo, hi = mesh.bins(shape[bin_axis])[j]
                pshape[bin_axis] = hi - lo
            row.append(torch.zeros(pshape, dtype=dtype,
                                   device=mesh.devices[i, j]))
        parts.append(row)
    return Sharded(mesh, parts, row_axis, bin_axis, shape, dtype)


def gather(sh: Sharded) -> torch.Tensor:
    """The whole tensor of ``sh`` on the mesh's first device, once every
    cell that ran has been joined."""
    mesh = sh.mesh
    mesh.join()
    out = torch.empty(sh.shape, dtype=sh.dtype, device=mesh.first)
    seen = set()
    for i, j, _ in mesh.cells():
        p = sh.parts[i][j]
        r, b = sh.ranges(i, j)
        key = (r, b)
        if key in seen or p.numel() == 0:
            continue
        seen.add(key)
        _cell_slice(out, sh.row_axis, sh.bin_axis, r, b).copy_(
            p, non_blocking=True)
    return out


class ShardedGraph:
    """The block step of one GraphSpec over a mesh: the twin of the JAX
    package's ``ShardedGraph`` (parallel/mesh.py:221-302). ``kernel``
    says whether the shape takes the kernel routes on this mesh
    (``shardable``; the JAX package's ``mac == "pallas"``), else the
    per-shard stage loop, the port's counterpart of the JAX dense MAC.
    The JAX package's lane-tiled layout (``tiled``) has no counterpart:
    the port's ring is flat."""

    def __init__(self, spec, mesh: Mesh):
        self.spec = spec
        self.mesh = mesh
        self.kernel = shardable(mesh, spec.n_filters, spec.n_bins,
                                spec.real_dtype)

    def init_state(self, ring_dtype=None):
        """The step state: the ring split over the mesh ('f' rows, 'sp'
        bins), of ``ring_dtype`` (default: the graph's real type), the
        overlap-save and cascade tails and the block counter on the first
        device."""
        from ..graph.compile import StepState, real_dtype
        s, dev = self.spec, self.mesh.first
        rd = real_dtype(s)
        N = s.block_length
        return StepState(
            prev_in=torch.zeros((s.n_inputs, N), dtype=rd, device=dev),
            ring=zeros(self.mesh, s.ring_shape(), ring_dtype or rd, 0, 3),
            eval_prev=torch.zeros((s.n_casc, N), dtype=rd, device=dev),
            t=torch.zeros((), dtype=torch.int32, device=dev))

    def place(self, ctrl, bank, x=None):
        """(ctrl on the mesh, the bank split over 'sp', x on the first
        device): ``ctrl`` a StepCtrl, ``bank`` [E, B, 2, K]."""
        from ..graph.compile import place_ctrl
        xs = None if x is None else to_device(x, self.mesh.first)
        return (place_ctrl(self.mesh, ctrl), split(self.mesh, bank, None, 3),
                xs)

    def step(self, state, ctrl, bank, x, xfade=False, uniform=False,
             uniform_delay=False):
        """One block through ``graph.compile.step_impl`` on the mesh:
        ``ctrl`` and ``bank`` as ``place`` returns them; ``xfade`` as
        ``step_impl``'s ``xfade_now`` (the host always knows)."""
        from ..graph.compile import step_impl
        return step_impl(self.spec, state, ctrl, bank, x, uniform=uniform,
                         uniform_delay=uniform_delay, xfade_now=bool(xfade),
                         mesh=self.mesh)
