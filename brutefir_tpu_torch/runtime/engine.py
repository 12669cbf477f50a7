"""The engine: host pipeline around the per-block device step.

Torch twin of :mod:`brutefir_tpu.runtime.engine`, with two loops:

- ``run``: the per-block loop (engine.py:1118-1310, 1390-1620). The main
  thread reads a block of raw words, fires the logic modules'
  ``block_start`` hooks (the CLI's script mode runs one script line
  there), takes one control snapshot under ``control_mutex`` and
  dispatches the block through the device-IO program; a writer thread
  fetches, meters and writes the results. Clocked devices (a sound card,
  ``uses_sample_clock``) run here at the fixed latency of 2N samples.
- ``run_offline``: the batched loop. A producer thread reads and uploads
  batches of ``BATCH_BLOCKS`` blocks, the main thread dispatches each
  batch with its controls frozen, and the same writer thread writes. A
  crossfade lands on one block: the batch dispatches its crossfade
  blocks one at a time and the rest under the same snapshot. A config
  with logic modules falls back to ``run``.

Under ``benchmark: true;`` or ``debug: true;`` ``run`` prints the
reference's stage table every 10 periods (bfrun.c:2035-2078): host ms a
block to read, to snapshot and dispatch ("device": the host's enqueue
time, as dispatch is asynchronous), to hand the block to the writer, and
in all; with ``BRUTEFIR_TPU_STAGE_BREAKDOWN=1`` the device column is split
by the device times of one block of the engine's route, column by column
(``runtime/stageprobe.py``). ``debug: true;`` also
dumps the input/filter/output event timeline at the end of the run.

The fixed-latency contract holds: output frame m is the convolution of
input frames <= m, and file-to-file output length equals input length
(the EOF tail runs block by block).

Two routes carry a block's samples, chosen once from the config as the
JAX package chooses them (``self.dio``):

- the device-IO path (``runtime/device_io.py``), when every device's
  format has a device codec: raw words go to the card, and decode,
  channel delays, subsample delays, dither and encode run there;
- the host codec path, when one does not (big-endian words, 3-byte
  big-endian S24, 8-byte floats), for every device of the config:
  ``read_block`` decodes (``core/codecs.py``, the native C++ codec of
  ``core/native`` or numpy) and runs the input mutes, delay lines
  (``core/delayline.py``) and subsample delays on the host; the block
  goes up through a pinned staging buffer into the static input of the
  path's step programs (``self.host_step``, ``runtime/program.HostStep``:
  ``graph/compile.step_impl`` with the same kernels as on the device
  path, one captured CUDA graph a key on the card; under
  frequency-domain taps a ``TapStep``, one graph a segment between tap
  sites, the hooks run on the host between them), and the writer thread fetches
  the output and ``write_block`` runs the output subdelays, delay lines,
  mutes, dither (``DitherState.quantize``), meters and encode.

Runtime delay and subdelay changes land on the block boundary of the
control snapshot that carries them.

The EQ logic module hot-swaps coefficient sets through
``update_bank_entry``, which rebinds a new bank tensor: a block takes the
bank of its control snapshot, so blocks already dispatched keep theirs.

Logic modules (``attach_logic``): ``cli``, ``eq`` and external
``bflogic_<name>.py`` modules from ``modules_path``, with every bfevents
hook of bfmod.h:192-215. A module that defines ``input_timed`` /
``output_timed`` or a frequency-domain hook (``input_freqd``,
``pre_convolve``, ``post_convolve``, ``output_freqd``) puts the engine on
the host codec path, as in the JAX package: the timed hooks see the host
blocks of ``read_block`` / ``write_block``, and each frequency-domain
hook is a tap in the step (``_make_freqd_tap``) that fetches its spectra
to the host, calls the hooks and uploads the result, between two
segments of the step's captured graphs (``runtime/program.TapStep``).

Clocked devices (engine.py:471-483, 781-936, 1001-1028, 1147-1257,
1312-1388, 1599-1620): ``setup()`` opens the devices, runs every step
variant on zeros before a clocked device starts
(``_warm_programs``: the kernels' build, cuFFT plans, the allocator's
blocks, the capture of the step programs; no module hook and no
persistent state sees it), asks for
SCHED_FIFO and ``mlockall`` (``_maybe_go_realtime``), starts the
devices, writes two silent fragments to each clocked output
(``_iodelay_fill``) and fires ``synch_start``. Inputs that cannot
signal period boundaries run in poll mode (``_read_device``).
``run()`` echoes the rti under ``show_progress``, aborts on a sample
rate drift past 2% under ``monitor_rate``, arms the opt-in stall
watchdog (``BRUTEFIR_TPU_WATCHDOG``) and, with ``sink_output``, runs the
sink mode with its prefetch pool.

``float_bits: 64`` runs in float64 end to end, as in the JAX package
(engine.py:129-153, which refuses its TPU for want of a float64 FFT): the
bank, the ring and state, the controls, the gains, the device codec and
dither, the host path's staging, the taps' complex128 rows; the step
takes the JAX package's float64 routes (``graph/compile.py``) through the
float64 forms of the unfused MAC and the FFT glue.

Several devices (engine.py:105-111, 163-240, 385-399): ``Engine(conf,
mesh=...)`` runs the block step over an ('f', 'sp') mesh of devices
(``parallel/mesh.py``), one process driving every shard; without
``mesh=`` an automatic one is picked from ``BRUTEFIR_TPU_MESH`` (``auto``
over every visible card by default, ``off``, or ``FxS``) as the JAX
package picks it. Manual ``filter { process: N; }`` pins place each
process group on its own rows of the 'f' axis (padded with inert rows);
without an 'f' axis to place onto they have no effect, and the engine
says so. Frequency-domain hooks need one device: an automatic mesh steps
down to its first device, an explicit one refuses them.

Reduced-precision state (engine.py:286-298, compile.py:84-95): under
``BRUTEFIR_TPU_BANK_DTYPE=bf16`` the coefficient bank, and under
``BRUTEFIR_TPU_RING_DTYPE=bf16`` the spectra ring, are stored as
bfloat16 on a float32 graph (both read once, here; a float64 graph
ignores them). The bank is cast on the host before a mesh splits it, so
every shard is bfloat16, and ``update_bank_entry`` casts an EQ render or
coefficient swap to it; the MAC kernels' bf16 forms widen both on load.
Not the bit-parity contract: defaults stay the graph's type.

``BRUTEFIR_TPU_PROFILE=<dir>`` wraps ``run()`` (as the JAX package
does, engine.py:1137-1139, 1269-1287) and ``run_offline``, the CLI's
default for files, in a ``torch.profiler`` trace of the host and the
card, written to the directory as one Chrome trace when the run ends,
normally or by an error. The trace carries the engine's own spans
(``runtime/tracing.py``: the producer's reads and uploads, the
dispatches and their waits, the writer's parts) on the card's
timeline, one track a thread.

Not ported: the powersave dispatch skip (the JAX package makes it
byte-identical to always dispatching, so the port always dispatches).
"""

from __future__ import annotations

import collections
import json
import os
import queue
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config.coeffs import build_bank
from ..config.model import BFConfig, IN, OUT
from ..control import load_logic_module
from ..core.codecs import Overflow, float_to_raw, raw_to_float
from ..core.delayline import DelayLine
from ..core.dither import DitherTable
from ..errors import BFError, BF_EXIT_INVALID_INPUT, BF_EXIT_OTHER
from ..graph.compile import (check_supported, init_state, read_ring_dtype,
                             real_dtype, step_impl)
from ..graph.spec import build_graph_spec
from ..io import get_io_module
from ..ops.partconv import np_c2p, np_p2c, pack_spectrum, unpack_spectrum
from ..parallel import mesh as mesh_mod
from .control import RuntimeControl
from .device_io import DeviceIO, dithered_phys, eligible
from .staging import Staging
from .program import HostStep, TapStep, tree_map
from . import tracing
from .subdelay import SubsampleDelay
from .tracing import RECORDER as REC

# blocks per offline dispatch: block latency becomes BATCH_BLOCKS * N
BATCH_BLOCKS = 8

# the debug timeline's sections (print_debug, bfrun.c:230-434): a span
# name -> (stage, its start's event, its end's event)
DEBUG_EVENTS = {"read": ("input", "call read", "ret {frames} frames"),
                "dispatch": ("filter", "call dispatch", "ret"),
                "write": ("output", "call write", "ret {frames} frames")}
DEBUG_SPANS = 4096


FREQD_HOOKS = ("input_freqd", "pre_convolve", "post_convolve",
               "output_freqd")


class EngineError(BFError):
    pass


def _locked_kib() -> dict:
    """The process's locked and resident memory, KiB (/proc/self/status
    VmLck and VmRSS); empty where the file is missing."""
    out = {}
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                key, _, val = line.partition(":")
                if key in ("VmLck", "VmRSS"):
                    out[key.lower() + "_kib"] = int(val.split()[0])
    except OSError:
        pass
    return out


def _wait_for(result) -> None:
    """Block until the device work behind ``result`` (a tensor or a list
    of tensors from the step) is done, without fetching it: the stream is
    in order, so an event recorded now covers it and everything before."""
    t = result[0] if isinstance(result, (list, tuple)) else result
    if isinstance(t, torch.Tensor) and t.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        ev.synchronize()


def _spectra_to_host(planes: torch.Tensor, ready=None) -> np.ndarray:
    """A tap's fetch: packed planes [C, 2, N] -> natural rfft rows
    [C, N+1], writable and C-contiguous (one copy off the card; none
    from a host buffer, once the event ``ready`` says the copy into it
    has landed)."""
    if ready is not None:
        ready.synchronize()
    return np.ascontiguousarray(unpack_spectrum(np_p2c(
        planes.cpu().numpy())))


def _spectra_to_device(z: np.ndarray, like: torch.Tensor,
                       out: torch.Tensor = None) -> torch.Tensor:
    """A tap's upload: natural rfft rows [C, N+1] -> packed planes
    [C, 2, N] of ``like``'s dtype on its device (one copy), or written
    into ``out`` (a host buffer of that dtype, which the step copies
    up)."""
    if out is not None:
        np_c2p(pack_spectrum(z), out.numpy())
        return out
    return torch.from_numpy(np_c2p(pack_spectrum(z))).to(like.device,
                                                         like.dtype)


def read_bank_dtype(real: torch.dtype) -> torch.dtype:
    """The bank's dtype: ``torch.bfloat16`` under
    ``BRUTEFIR_TPU_BANK_DTYPE=bf16`` (or ``bfloat16``) on a float32 graph
    (``real``, the graph's real type), as the JAX engine reads it
    (engine.py:295-298); else ``real``."""
    env = os.environ.get("BRUTEFIR_TPU_BANK_DTYPE", "")
    if env in ("bf16", "bfloat16") and real == torch.float32:
        return torch.bfloat16
    return real


def pin_fp32_matmul() -> None:
    """Full FP32 in every matmul and convolution: TF32 keeps ~10 mantissa
    bits and costs thousands of LSB of S24 in the channel mixes (the
    analog of the JAX package's HIGHEST-precision pin)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Engine:
    """Runs a parsed config on ``device`` (None means ``cuda``; the CPU
    only when passed explicitly). ``mesh``: a ``parallel.mesh.Mesh`` to
    shard the block step over (its first device is then the engine's);
    None picks one from ``BRUTEFIR_TPU_MESH`` over the visible cards."""

    def __init__(self, conf: BFConfig, device=None, mesh=None):
        self.device = resolve_device(device)
        pin_fp32_matmul()
        self.conf = conf
        self.N = conf.filter_length
        self.B = conf.n_blocks
        self.rd = np.dtype(np.float32 if conf.realsize == 4 else np.float64)
        quiet = getattr(conf, "quiet", False)

        filter_inputs = [[src for src, _ in f.in_filters]
                         for f in conf.filters]
        crossfades = [f.crossfade for f in conf.filters]
        # manual filter -> process placement (bfconf.c:1024-1036; the
        # parser enforces all-or-none and the cross-process rules)
        manual_proc = [f.process for f in conf.filters]
        manual = bool(conf.filters) and all(p >= 0 for p in manual_proc)
        n_proc = (max(manual_proc) + 1) if manual else 0

        # an explicit mesh wins; else BRUTEFIR_TPU_MESH over the visible
        # cards, the analog of the reference's one filter process a CPU
        # (engine.py:170-194); a malformed value is a typed config error
        self._mesh_auto = False
        if mesh is None:
            self._mesh_auto = (os.environ.get("BRUTEFIR_TPU_MESH", "auto")
                               .strip().lower() in ("", "auto"))
            mesh = mesh_mod.auto_mesh(
                max(len(conf.filters), 1), self.N, self.rd,
                devices=mesh_mod.default_devices(self.device),
                f_pref=n_proc if manual else 0)
            if mesh is not None and not quiet:
                sys.stderr.write(
                    f"Multi-device mesh: f={mesh.shape['f']} x "
                    f"sp={mesh.shape['sp']} over "
                    f"{mesh.devices.size} devices\n")
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh.first

        # process groups on the 'f' axis: the filter axis permuted so each
        # group holds its own contiguous shard rows, padded to equal size
        # with inert rows (zero mixes), process id -> shard round-robin as
        # the reference folds processes onto CPUs (bfconf.c:2304-2316).
        # f2spec: config filter -> spec row; spec_rows: spec row -> config
        # filter (-1 a padding row); None: config order (engine.py:196-240)
        self.f2spec = None
        self.spec_rows = None
        if manual and mesh is not None and mesh.shape["f"] > 1:
            f_n = mesh.shape["f"]
            groups = [[] for _ in range(f_n)]
            for nf, p in enumerate(manual_proc):
                groups[p % f_n].append(nf)
            gsize = max(len(g) for g in groups)
            rows = []
            for g in groups:
                rows.extend(g + [-1] * (gsize - len(g)))
            f2spec = np.full(len(conf.filters), -1, np.int32)
            for row, nf in enumerate(rows):
                if nf >= 0:
                    f2spec[nf] = row
            self.f2spec = f2spec
            self.spec_rows = rows
            filter_inputs = [
                ([int(f2spec[s]) for s in filter_inputs[nf]] if nf >= 0
                 else []) for nf in rows]
            crossfades = [(crossfades[nf] if nf >= 0 else False)
                          for nf in rows]
            if not quiet:
                sys.stderr.write(
                    f"Manual process placement: {n_proc} process group(s) "
                    f"onto the {f_n}-way 'f' mesh axis "
                    f"({len(rows)} filter rows incl. padding)\n")
        elif manual and not quiet:
            # the reference pins work onto CPUs regardless; one device (or
            # an f = 1 mesh) has nowhere to place it
            sys.stderr.write(
                "Warning: filter process: settings have no effect "
                "(single device or no 'f' mesh axis to place onto)\n")

        self.spec = build_graph_spec(
            self.N, self.B, conf.n_channels[IN], conf.n_channels[OUT],
            filter_inputs, crossfades, self.rd,
            powersave=conf.powersave and conf.analog_powersave < 1.0)
        check_supported(self.spec)

        # [E, B, N] complex -> the kernel's [E, B, 2, N] re/im planes; under
        # a mesh each device takes its bin shards from the host copy. The
        # opt-in bf16 bank is cast here, on the host, before the split
        bank = torch.as_tensor(
            np_c2p(build_bank(conf.coeffs, self.N, self.B, self.rd.type)))
        bank = bank.to(read_bank_dtype(bank.dtype))
        self.ring_dtype = read_ring_dtype(self.spec)
        self._sharded = (mesh_mod.ShardedGraph(self.spec, mesh)
                         if mesh is not None else None)
        self.bank = (mesh_mod.split(mesh, bank, None, 3) if mesh is not None
                     else bank.to(self.device))
        self.control = RuntimeControl(conf, self.spec, self.device,
                                      spec_rows=self.spec_rows,
                                      f2row=self.f2spec, mesh=mesh)

        self.devices: List[list] = [[], []]
        reset_done = set()
        for io in (IN, OUT):
            for dev in conf.iodevs[io]:
                cls = get_io_module(dev.device_name, conf.modules_path)
                if cls not in reset_done:
                    reset_done.add(cls)
                    # clear module-global state a FAILED earlier config
                    # build left behind (ALSA's link group: a parse error
                    # raises before any handle opens, engine.py:306-318)
                    reset = getattr(cls, "reset_module_state", None)
                    if reset is not None:
                        reset()
                inst = cls(dev.device_params, io, dev.sample_format,
                           conf.sampling_rate, dev.open_channels)
                if inst.sample_format is not None:
                    dev.sample_format = inst.sample_format
                if dev.sample_format is None:
                    raise EngineError(
                        f'device "{dev.device_name}" did not resolve AUTO '
                        'format')
                self.devices[io].append(inst)

        self.subdelay = (SubsampleDelay(conf, self.rd)
                         if conf.use_subdelay[IN] or conf.use_subdelay[OUT]
                         else None)
        # the host path's per-virtual-channel delay lines. The subdelay's
        # compensating integer delay EXTENDS the capacity past the user's
        # maxdelay, as the reference allocates maxdelay + sdf_length
        # (bfrun.c:1152-1162), so a channel at its full delay stays
        # aligned with the subdelay-filtered channels
        self.dlines = [[], []]
        for io in (IN, OUT):
            for ch in range(conf.n_channels[io]):
                init = conf.delay[io][ch]
                md = conf.maxdelay[io][ch]
                if self.subdelay is not None:
                    extra = self.subdelay.extra_delay(io, ch)
                    init += extra
                    if md >= 0:
                        md += extra
                self.dlines[io].append(DelayLine(init, md, self.rd))
        # one shared random table for the dithered output channels
        # (dither_init, bfconf.c:3174-3238), read on the card by the
        # device-IO path and on the host by the host path's per physical
        # channel states (channel j of dithered_phys from j * spacing + 1)
        dith = dithered_phys(conf)
        self.dither_table = (DitherTable(len(dith), conf.sampling_rate,
                                         conf.max_dither_table_size, self.N,
                                         dtype=self.rd.type)
                             if dith else None)
        self.dither_state = [None] * conf.n_physical_channels[OUT]
        for j, p in enumerate(dith):
            self.dither_state[p] = self.dither_table.new_state(j)

        # overflow meters, per virtual output channel; shared per physical
        self.overflow: List[Overflow] = []
        self._phys_overflow = []
        for p in range(conf.n_physical_channels[OUT]):
            fmt = conf.physical_format(OUT, p)
            self._phys_overflow.append(
                Overflow(max=1.0 if fmt.is_float else float(fmt.imax)))
        for ch in range(conf.n_channels[OUT]):
            self.overflow.append(self._phys_overflow[conf.virt2phys[OUT][ch]])

        self.state = (self._sharded.init_state(self.ring_dtype)
                      if mesh is not None
                      else init_state(self.spec, self.device,
                                      self.ring_dtype))
        self.control_mutex = threading.RLock()
        self.blockcounter = 0
        self.realtime_index = 0.0    # the CLI's rti reads it
        self._rti_max = 0.0
        # full-processing ramp of the rti meter (procblocks,
        # bfrun.c:1436-1445, 1567-1571)
        self._procblocks = 0
        self.logic = []              # logic module instances
        self._peak_hooks = []        # bfevents.peak analogs
        self._last_peak_state = None
        self._stopped = False
        self._stage_t = np.zeros(4)   # read, device, write, total
        self._stage_blocks = 0
        # set by attach_logic: input_timed / output_timed hooks, and the
        # frequency-domain taps of the step by hook kind
        self._has_timed_hooks = False
        self.taps = {}
        # the device-IO path when every device format has a device codec,
        # else the host codec path for all devices (engine.py:456)
        self.dio = DeviceIO(self) if eligible(conf) else None
        # the host codec path's step programs (_host_route)
        self.host_step = None
        self._host_route()
        self._gain_version = -1
        self._in_gain = self._out_gain = None
        self._v2p_in = np.asarray(conf.virt2phys[IN], dtype=np.int64)
        self._out_is_permutation = all(n == 1
                                       for n in conf.n_virtperphys[OUT])
        if self._out_is_permutation:
            self._p2v_out = np.asarray(
                [conf.phys2virt[OUT][p][0]
                 for p in range(conf.n_physical_channels[OUT])],
                dtype=np.int64)
        self._in_framebytes = [
            d.sample_format.bytes * d.open_channels for d in conf.iodevs[IN]]
        self._out_framebytes = [
            d.sample_format.bytes * d.open_channels for d in conf.iodevs[OUT]]
        # host path: per-device parallel encode (made in setup(), for more
        # than one output device on a multi-core host; the C codec
        # releases the GIL) and two pinned staging buffers for the upload
        self._encode_pool = None
        self._upload_bufs = []
        self._upload_turn = 0
        # the offline pipeline's reused host buffers (staging.py)
        self.staging = Staging(self.device)
        # set while _warm_programs runs the step on zeros: the taps skip
        # their hooks, so no module sees the warm-up
        self._warming = False
        # what _maybe_go_realtime got: SCHED_FIFO, mlockall's return code
        # and errno, and the process's locked and resident KiB after it
        self.realtime_state = {}

        # input poll mode (dai.c:905-931): every clocked, non-callback
        # input misaligned -> reads paced by short sleeps
        clocked_in = [i for i in self.devices[IN]
                      if i.uses_sample_clock and not i.is_callback]
        self._poll_mode = (bool(clocked_in)
                           and all(i.bad_alignment for i in clocked_in))
        if self._poll_mode:
            if not conf.allow_poll_mode:
                raise EngineError(
                    "sound input hardware requires poll mode to be "
                    "activated but current configuration does not allow "
                    "it (allow_poll_mode: false;)")
            if not getattr(conf, "quiet", False):
                sys.stderr.write("Input poll mode activated\n")

    def stop(self):
        self._stopped = True

    def update_bank_entry(self, coeff_index: int, H: np.ndarray):
        """Hot-swap one coefficient set's spectral partitions (the EQ
        render), out of place like the JAX package's functional update: a
        new bank tensor is rebound under the control mutex, so a block
        dispatched with the old one (its snapshot's) is unaffected, even
        when the EQ runs on a CLI socket thread. Under a mesh every bin
        shard of the bank is written. ``H`` is cast to the bank's dtype
        (a bfloat16 bank: rounded to nearest even, as the JAX package's
        ``jnp.asarray(H, bank.dtype)``)."""
        H = torch.as_tensor(np.asarray(H).reshape(self.bank.shape[1:]))
        H = H.to(self.bank.dtype)
        if self.mesh is not None:
            def write(part, i, j):
                k0, k1 = self.mesh.bins(H.shape[-1])[j]
                dev = part.device
                return part.index_copy(
                    0, torch.tensor([coeff_index], device=dev),
                    H[None, ..., k0:k1].to(dev))
            bank = self.bank.map(write)
        else:
            H = H.to(self.device)
            idx = torch.tensor([coeff_index], device=self.device)
            bank = self.bank.index_copy(0, idx, H[None])
        with self.control_mutex:
            self.bank = bank

    # ----- logic modules ---------------------------------------------------
    def attach_logic(self):
        """Load the config's logic modules (``cli``, ``eq`` or an external
        ``bflogic_<name>.py`` from ``modules_path``) and wire their hooks,
        those of modules appended to ``self.logic`` beforehand included
        (engine.py:488-572 without the relay probe, ROADMAP queue 1 item
        13): the timed hooks, the frequency-domain taps, the coeff_final
        hooks, the peak push, and each module's ``initialised``. Timed
        hooks or any tap put every block on the host codec path
        (``self.dio`` None, engine.py:497-499, :556); ``run()`` attaches
        before ``setup()``, which makes that path's encode pool. Taps need
        one device: under an automatic mesh the engine steps down to its
        first device with the JAX package's warning; an explicit mesh
        (``mesh=`` or ``BRUTEFIR_TPU_MESH=FxS``) raises EngineError."""
        for name, params in self.conf.logic_modules:
            self.logic.append(load_logic_module(name, params, self,
                                                self.conf.modules_path))
        self._has_timed_hooks = any(
            getattr(m, "input_timed", None) is not None
            or getattr(m, "output_timed", None) is not None
            for m in self.logic)
        # frequency-domain hooks (bfevents input_freqd / pre_convolve /
        # post_convolve / output_freqd), each kind one tap of the step
        # calling its hooks in module order
        taps = {}
        for kind in FREQD_HOOKS:
            hooks = [getattr(m, kind) for m in self.logic
                     if getattr(m, kind, None) is not None]
            if hooks:
                # pre/post_convolve name filters: under process placement
                # the step's ids are spec rows, the module ABI speaks
                # config filters (padding rows are skipped)
                row2conf = (self.spec_rows
                            if kind in ("pre_convolve", "post_convolve")
                            else None)
                taps[kind] = self._make_freqd_tap(
                    hooks, row2conf, warming=lambda: self._warming)
        if taps and self.mesh is not None:
            if not self._mesh_auto:
                raise EngineError(
                    "frequency-domain module hooks require a single "
                    "device (BRUTEFIR_TPU_MESH=off, or drop the explicit "
                    "mesh)")
            if not getattr(self.conf, "quiet", False):
                sys.stderr.write(
                    "Multi-device mesh disabled: a logic module "
                    "registered frequency-domain hooks (single-device "
                    "only)\n")
            self._drop_mesh()
        self.taps = taps
        if self._has_timed_hooks or taps:
            self.dio = None
        self._host_route()
        self.control.coeff_final_mod_hooks = [
            m.coeff_final for m in self.logic
            if getattr(m, "coeff_final", None) is not None]
        # peak push (BF_FDEVENT_PEAK / bfevents.peak, bfrun.c:589-618)
        self._peak_hooks = [m.peak for m in self.logic
                            if getattr(m, "peak", None) is not None]
        self._last_peak_state = tuple(
            (o.n_overflows, o.largest, o.intlargest) for o in self.overflow)
        for m in self.logic:
            hook = getattr(m, "initialised", None)
            if hook is not None:
                hook()

    def _drop_mesh(self):
        """Step down from the mesh to its first device (engine.py:538-558):
        the bank gathered there, a fresh state, the controls' next
        snapshot a plain StepCtrl."""
        self.bank = mesh_mod.gather(self.bank)
        self.mesh = None
        self._sharded = None
        self.state = init_state(self.spec, self.device, self.ring_dtype)
        with self.control_mutex:
            self.control.mesh = None
            self.control.mark_dirty()
        if self.dio is not None:
            self.dio.mesh = None

    def _host_route(self):
        """The host codec path's step programs (``self.host_step``): a
        ``runtime/program.HostStep`` on that path, a ``TapStep`` (one
        captured graph a segment between tap sites) under
        frequency-domain taps, each kept while the engine stays on its
        route; None on the device-IO path."""
        if self.dio is not None:
            self.host_step = None
        elif self.taps:
            if (not isinstance(self.host_step, TapStep)
                    or self.host_step.taps is not self.taps):
                self.host_step = TapStep(self.spec, self.device, self.taps)
        elif self.host_step is None:
            self.host_step = HostStep(self.spec, self.device, self.mesh)

    @staticmethod
    def _make_freqd_tap(hooks, row2conf=None, warming=None):
        """A tap of the step (engine.py:574-602): planes [C, 2, N] ->
        natural rfft rows [C, N+1] (complex64 from float32 planes,
        complex128 from float64 ones, writable, C-contiguous) -> ``h(row,
        id)`` for each row and each hook in order -> planes back, of the
        planes' dtype on their device. ``id`` is the input channel, the filter or the output
        channel of the row, in config numbering. A hook mutates its row
        in place; the imaginary parts of the DC and Nyquist bins are
        dropped on the way back (the packed layout has no room for them).

        On the card each tap is one copy to the host, which waits for the
        step's work queued before it, and one copy back: a host sync in
        the middle of the step, the cost of the module ABI (the reference
        hands its modules host buffers), not a fallback. The tapped
        step's programs (``runtime/program.TapStep``) call it on a pinned
        host buffer that their segment's copy fills, with ``ready`` the
        event to wait on and ``out`` that buffer itself: the planes come
        back in place, and the next segment copies them up.

        ``row2conf`` maps spec rows to config filters (padding rows -1
        skip the hooks): the engine's ``spec_rows`` under ``process:``
        placement, else None (spec rows are config order).
        ``warming`` (the engine's ``_warming`` gate, engine.py:586-589):
        while it returns True the tap hands the planes back untouched and
        calls no hook, so a module never sees ``_warm_programs``' blocks."""

        def tapfn(planes, idx, ready=None, out=None):
            if warming is not None and warming():
                return planes
            z = _spectra_to_host(planes, ready)
            for ch in range(z.shape[0]):
                fid = int(idx[ch])
                if row2conf is not None:
                    fid = row2conf[fid]
                    if fid < 0:
                        continue
                row = z[ch]
                for h in hooks:
                    h(row, fid)
            return _spectra_to_device(z, planes, out)

        return tapfn

    def _peak_push(self):
        """Push a peak event to logic modules when an overflow meter
        changed (check_overflows, bfrun.c:589-618), gated on
        overflow_warnings like the reference."""
        if not self._peak_hooks or not self.conf.overflow_warnings:
            return
        cur = tuple((o.n_overflows, o.largest, o.intlargest)
                    for o in self.overflow)
        if cur != self._last_peak_state:
            self._last_peak_state = cur
            for h in self._peak_hooks:
                h()

    def _block_start_hooks(self):
        for mod in self.logic:
            hook = getattr(mod, "block_start", None)
            if hook is not None:
                hook(self.blockcounter)

    # ----- setup / teardown ----------------------------------------------
    def setup(self):
        if (self.dio is None and len(self.conf.iodevs[OUT]) > 1
                and (os.cpu_count() or 1) > 1):
            from concurrent.futures import ThreadPoolExecutor
            self._encode_pool = ThreadPoolExecutor(
                max_workers=min(len(self.conf.iodevs[OUT]),
                                max(1, (os.cpu_count() or 2) - 1)),
                thread_name_prefix="bf-encode")
        for io in (IN, OUT):
            for inst in self.devices[io]:
                inst.init(self.N)
        self._warm_programs()
        self._maybe_go_realtime()
        for io in (IN, OUT):
            for inst in self.devices[io]:
                inst.start()
        self._iodelay_fill()
        # synchronized start fires when processing begins, after the
        # iodelay fill (dai.c:720 for callback modules, dai.c:1178 for
        # modules that declare it, e.g. ALSA's linked snd_pcm_start)
        for io in (IN, OUT):
            for inst in self.devices[io]:
                inst.synch_start()

    def _clocked(self) -> bool:
        return any(inst.uses_sample_clock
                   for io in (IN, OUT) for inst in self.devices[io])

    def _warm_programs(self):
        """Run every step variant that ``_snapshot_epoch`` can pick on
        zeros before a clocked device starts (engine.py:798-862), so the
        first audio block and a later control change pay no first-use
        cost: the kernels' nvcc build and ctypes load, cuFFT plans, the
        glue tables, the caching allocator's blocks and, on the host path,
        the pinned staging buffers. The variants: ``uniform`` False and
        True, ``xfade`` True as well when a filter can crossfade, the
        snapshot's ``uniform_delay``. Each is a key of ``DeviceIO.step``
        on the device-IO path, of ``HostStep.step`` through
        ``_dispatch_host`` on the host path (with taps ``TapStep.step``),
        called on the engine's own state, twice where the programs are
        captured (``captures``): the key's first call warms up, its
        second captures the key's CUDA graph, or under taps its
        segments' graphs (``runtime/program.py``), so a clocked run never
        captures inside its realtime loop.

        The warm-up leaves no trace: the state and, on the device-IO path,
        ``dstate`` (the dither pointers are part of the bit-exact dither
        sequence) are cloned before and handed back after, the next block
        copying them into the programs' static tensors; the host path
        dispatches only, never ``read_block`` / ``write_block``, so delay
        lines and host dither states stay put; ``_warming`` silences the
        taps' hooks (a silenced tap hands its planes on unchanged, so the
        next segment reads defined data).
        Clockless (file) runs skip it, and so do runs on a mesh, as in the
        JAX package (engine.py:806). A failure is reported and left to the
        audio path, as there."""
        if not self._clocked() or self.mesh is not None:
            return
        # run() attaches the logic modules before setup(), so the
        # variants warmed here are the ones that run (taps, host path)
        self._warming = True
        try:
            with self.control_mutex:
                ctrl = self.control.snapshot()
                g0, g1 = self._mute_gains()
                udl = self.control.snapshot_uniform_delay
            xfs = ((False, True)
                   if any(f.crossfade for f in self.conf.filters)
                   else (False,))
            state0 = tree_map(torch.clone, self.state)
            if self.dio is not None:
                words = [torch.as_tensor(
                    np.zeros((self.N,) + tuple(self.dio.in_wire_shape[i]),
                             self.dio.in_wire_dtype[i]), device=self.device)
                    for i in range(len(self.conf.iodevs[IN]))]
                dstate0 = tree_map(torch.clone, self.dio.dstate)
                reps = 2 if self.dio.captures else 1

                def step(uni, xf):
                    self.state = self.dio.step(
                        self.state, ctrl, g0, g1, self.bank, list(words),
                        uniform=uni, udelay=udl, xfade=xf)[0]
            else:
                x = np.zeros((self.conf.n_channels[IN], self.N), self.rd)
                reps = (2 if self.host_step is not None
                        and self.host_step.captures else 1)

                def step(uni, xf):
                    self._dispatch_host(x, (ctrl, (g0, g1), uni, udl, xf,
                                            self.bank, None))
            try:
                for uni in (False, True):
                    for xf in xfs:
                        for _ in range(reps):
                            step(uni, xf)
            finally:
                self.state = state0
                if self.dio is not None:
                    self.dio.dstate = dstate0
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except Exception as e:
            sys.stderr.write(
                f"Warning: step-program warmup failed ({type(e).__name__}: "
                f"{e}); the first use will be retried on the audio path.\n")
        finally:
            self._warming = False

    def _iodelay_fill(self):
        """Pre-write 2 silent fragments to each clocked, non-callback
        output (engine.py:864-888; the reference's iodelay_fill,
        dai.c:1451-1457): the fixed 2N-sample I/O latency, a full double
        buffer of cushion against block-time jitter."""
        clocked = [(di, inst) for di, inst in enumerate(self.devices[OUT])
                   if inst.uses_sample_clock and not inst.is_callback]
        if not clocked:
            return
        conf = self.conf
        if not getattr(conf, "quiet", False):
            delay = 2 * self.N
            if conf.use_subdelay[IN]:
                delay += conf.sdf_length
            if conf.use_subdelay[OUT]:
                delay += conf.sdf_length
            sys.stderr.write(f"Fixed I/O-delay is {delay} samples\n"
                             "Audio processing starts now\n")
        for _ in range(2):
            for di, inst in clocked:
                inst.write(b"\0" * (self.N * self._out_framebytes[di]))

    def _maybe_go_realtime(self):
        """SCHED_FIFO at priority 4 and, under ``lock_memory``,
        ``mlockall(MCL_CURRENT | MCL_FUTURE)`` when a device is clocked,
        with the reference's EPERM fallback (engine.py:890-913,
        bf_make_realtime, bfrun.c:2735-2788). It runs after
        ``_warm_programs``, so the allocator's blocks and the pinned
        buffers exist before the lock. ``realtime_state`` records what
        took."""
        if not self._clocked():
            return
        try:
            os.sched_setscheduler(0, os.SCHED_FIFO, os.sched_param(4))
        except (PermissionError, OSError):
            sys.stderr.write(
                "Warning: failed to set realtime priority (not permitted); "
                "continuing with default scheduling.\n")
            self.realtime_state = {"sched_fifo": False}
            return
        self.realtime_state = {"sched_fifo": True}
        if self.conf.lock_memory:
            try:
                import ctypes
                libc = ctypes.CDLL(None, use_errno=True)
                rc = libc.mlockall(3)    # MCL_CURRENT | MCL_FUTURE
                self.realtime_state.update(mlockall=rc,
                                           errno=ctypes.get_errno())
            except OSError:
                pass
            self.realtime_state.update(_locked_kib())

    def teardown(self):
        if self._encode_pool is not None:
            self._encode_pool.shutdown(wait=True)
            self._encode_pool = None
        # xrun report of callback-bridged devices (engine.py:915-931): the
        # bridge counts them, the native ring included
        if not getattr(self.conf, "quiet", False):
            for io in (IN, OUT):
                for inst in self.devices[io]:
                    n = getattr(inst, "native_xruns", None)
                    if n is None:
                        n = ((getattr(inst, "underruns", 0) or 0)
                             + (getattr(inst, "overruns", 0) or 0))
                    n = int(n)
                    if n:
                        sys.stderr.write(
                            f"Warning: {n} xrun(s) on "
                            f"{'input' if io == IN else 'output'} device "
                            f'"{inst.__class__.__name__}"\n')
        for io in (IN, OUT):
            for inst in self.devices[io]:
                inst.synch_stop()
                inst.stop()
                inst.close()

    def _mute_gains(self):
        ver = self.control.mute_version
        if ver != self._gain_version:
            rd = real_dtype(self.spec)
            self._in_gain = torch.tensor(
                [0.0 if m else 1.0 for m in self.control.mute[IN]],
                dtype=rd, device=self.device)
            self._out_gain = torch.tensor(
                [0.0 if m else 1.0 for m in self.control.mute[OUT]],
                dtype=rd, device=self.device)
            self._gain_version = ver
        return self._in_gain, self._out_gain

    def _snapshot_epoch(self):
        """One control epoch for a dispatch: (ctrl, gains, uniform,
        uniform_delay, xfade, bank, out_snap), taken under the control
        mutex so that a concurrent CLI line is never seen half applied
        (bfrun.c:1574-1601). The device-IO path's delays and subdelays
        are updated from the same epoch; on the host path ``out_snap`` is
        the output side's (delay, mute, subdelay) lists for
        ``write_block`` (engine.py:1522-1538), else None."""
        sp = REC.on and REC.begin("snapshot")
        with self.control_mutex:
            ctrl = self.control.snapshot()
            gains = self._mute_gains()
            out_snap = None
            if self.dio is not None:
                delays = [list(d) for d in self.control.delay]
                subdelays = [list(d) for d in self.control.subdelay]
            else:
                out_snap = (list(self.control.delay[OUT]),
                            list(self.control.mute[OUT]),
                            list(self.control.subdelay[OUT]))
            epoch = (ctrl, gains, self.control.snapshot_uniform,
                     self.control.snapshot_uniform_delay,
                     self.control.snapshot_xfade, self.bank, out_snap)
        if self.dio is not None:
            self.dio.update_delays(*delays)
            self.dio.update_subdelays(*subdelays)
        if sp:
            REC.end(sp)
        return epoch

    # ----- host codec path: input ---------------------------------------------
    def read_block(self):
        """Read one fragment from all input devices and decode it on the
        host (engine.py:627-679): (x [C_in, N] float, frames), frames < N
        at EOF (the block is zero padded). Input mutes zero a channel
        BEFORE its delay line and subdelay, whose state keeps advancing."""
        conf = self.conf
        N = self.N
        phys = np.zeros((conf.n_physical_channels[IN], N), self.rd)
        frames = N
        for di, dev in enumerate(conf.iodevs[IN]):
            want = N * self._in_framebytes[di]
            raw = self._read_device(self.devices[IN][di], want,
                                    self._in_framebytes[di])
            got_frames = len(raw) // self._in_framebytes[di]
            if got_frames < N:
                frames = min(frames, got_frames)
            buf = np.frombuffer(raw, dtype=np.uint8)
            if len(raw) < want:
                buf = np.concatenate(
                    [buf, np.zeros(want - len(raw), np.uint8)])
            rows = raw_to_float(buf, dev.sample_format, N, dev.open_channels,
                                dev.channel_selection, self.rd)
            phys[dev.phys_base: dev.phys_base + dev.used_channels] = rows
        # map to virtual channels with per-virtual delay and mute
        if self._plain_path(IN) and not self._has_timed_hooks:
            return np.ascontiguousarray(phys[self._v2p_in]), frames
        x = np.zeros((conf.n_channels[IN], N), self.rd)
        zero_row = np.zeros(N, self.rd)
        for ch in range(conf.n_channels[IN]):
            row = (zero_row if self.control.mute[IN][ch]
                   else phys[conf.virt2phys[IN][ch]])
            dl = self.dlines[IN][ch]
            dl.set_delay(self._total_delay(IN, ch))
            row = dl.process(row)
            if self.subdelay is not None:
                row = self.subdelay.process(IN, ch, row,
                                            self.control.subdelay[IN][ch])
            x[ch] = row
        for mod in self.logic:
            hook = getattr(mod, "input_timed", None)
            if hook is not None:
                for ch in range(conf.n_channels[IN]):
                    hook(x[ch], ch)
        return x, frames

    def _plain_path(self, io: int) -> bool:
        """True when no delay, mute or subdelay is active on any channel
        of this side, so the virtual mapping reduces to a gather."""
        ctrl = self.control
        return (self.subdelay is None
                and not any(ctrl.mute[io])
                and all(d == 0 for d in ctrl.delay[io])
                and all(dl.delay == 0 for dl in self.dlines[io]))

    def _total_delay(self, io: int, ch: int) -> int:
        d = self.control.delay[io][ch]
        if self.subdelay is not None:
            d += self.subdelay.extra_delay(io, ch)
        return d

    def _input_silent(self, x) -> bool:
        """Powersave silence of a decoded input block (test_silent,
        bfrun.c:722-772): exact zero for digital powersave, below the
        analog threshold (rounded to the step's real type) when one is
        configured; it only gates the rti meter here."""
        if not self.conf.powersave or x is None:
            return False
        thr = self.conf.analog_powersave
        if thr >= 1.0:
            peak = float(np.abs(x).max()) if x.size else 0.0
            return peak == 0.0
        if not x.size:
            return True
        scales = np.maximum(
            np.asarray(self.control.virtscale[IN], np.float64), 1e-30)
        thr32 = (thr / scales[: x.shape[0]]).astype(self.rd)
        peaks = np.abs(np.asarray(x, self.rd)).max(axis=-1)
        return bool(np.all(peaks < thr32))

    def _dispatch_host(self, x: np.ndarray, epoch) -> torch.Tensor:
        """The host path's dispatch: upload x [C_in, N] into the static
        input of ``self.host_step`` and run the step under ``epoch``
        through the key's program (under taps its segments, the hooks
        run between them); returns y [C_out, N] on the device,
        unfetched."""
        hs = self.host_step
        ctrl, _, uni, udl, xf, bank, _ = epoch
        self._upload_host(x, hs.x)
        self.state, y = hs.step(self.state, ctrl, bank, uniform=uni,
                                udelay=udl, xfade=xf)
        return y

    def _dispatch_eager(self, x: np.ndarray, epoch) -> torch.Tensor:
        """The host path's eager dispatch: upload x and run ``step_impl``
        op by op, the taps included: the form the programs replace,
        where ``chip_smoke.eager_forms`` routes an engine."""
        ctrl, _, uni, udl, xf, bank, _ = epoch
        self.state, y = step_impl(self.spec, self.state, ctrl, bank,
                                  self._upload_host(x), uniform=uni,
                                  uniform_delay=udl, xfade_now=xf,
                                  taps=self.taps, mesh=self.mesh)
        return y

    def _upload_host(self, x: np.ndarray, out=None) -> torch.Tensor:
        """x [C_in, N] on the engine's device, into ``out`` if given: on
        the card an asynchronous copy from one of two pinned staging
        buffers, each reused only once the copy that last read it has
        completed."""
        if self.device.type != "cuda":
            xt = torch.as_tensor(x)
            return xt if out is None else out.copy_(xt)
        if not self._upload_bufs:
            self._upload_bufs = [
                (torch.empty(x.shape, dtype=real_dtype(self.spec),
                             pin_memory=True), torch.cuda.Event())
                for _ in range(2)]
        buf, done = self._upload_bufs[self._upload_turn]
        self._upload_turn ^= 1
        done.synchronize()
        buf.numpy()[...] = x
        xd = (buf.to(self.device, non_blocking=True) if out is None
              else out.copy_(buf, non_blocking=True))
        done.record()
        return xd

    # ----- host codec path: output ----------------------------------------------
    def write_block(self, y: np.ndarray, frames: int, out_snap=None):
        """Encode and write one block on the host (engine.py:698-779).
        ``out_snap`` is the output side's (delay, mute, subdelay) lists
        taken with the block's control snapshot, so a block written later
        by the writer thread applies the controls of its own block
        (bfrun.c:1460-1484); None reads the current ones."""
        conf = self.conf
        N = self.N
        if out_snap is None:
            out_snap = (list(self.control.delay[OUT]),
                        list(self.control.mute[OUT]),
                        list(self.control.subdelay[OUT]))
        snap_delay, snap_mute, snap_subdelay = out_snap
        for mod in self.logic:
            hook = getattr(mod, "output_timed", None)
            if hook is not None:
                for ch in range(conf.n_channels[OUT]):
                    hook(y[ch], ch)
        # NaN guard (bfrun.c:1900-1911): one sample per channel
        if y.shape[0] and not np.all(np.isfinite(y[:, 0])):
            raise EngineError("NaN or Inf values in the system! "
                              "Invalid input?",
                              exit_code=BF_EXIT_INVALID_INPUT)

        plain = (self.subdelay is None
                 and not any(snap_mute)
                 and all(d == 0 for d in snap_delay)
                 and all(dl.delay == 0 for dl in self.dlines[OUT]))
        if plain and self._out_is_permutation:
            phys = np.ascontiguousarray(y[self._p2v_out])
        else:
            phys = np.zeros((conf.n_physical_channels[OUT], N), self.rd)
            for ch in range(conf.n_channels[OUT]):
                row = y[ch]
                if self.subdelay is not None:
                    row = self.subdelay.process(OUT, ch, row,
                                                snap_subdelay[ch])
                dl = self.dlines[OUT][ch]
                d = snap_delay[ch]
                if self.subdelay is not None:
                    d += self.subdelay.extra_delay(OUT, ch)
                dl.set_delay(d)
                row = dl.process(row)
                if snap_mute[ch]:
                    continue
                phys[conf.virt2phys[OUT][ch]] += row

        limit = conf.safety_limit

        def encode_one(di, dev):
            rows = phys[dev.phys_base: dev.phys_base + dev.used_channels]
            if limit != 0.0:
                for i in range(dev.used_channels):
                    ovf = self._phys_overflow[dev.phys_base + i]
                    peak = (float(np.abs(rows[i]).max()) if rows.shape[1]
                            else 0.0)
                    if peak > limit * ovf.max:
                        raise EngineError(
                            f"safety limit exceeded on output "
                            f"({20 * np.log10(peak / ovf.max):.2f} > "
                            f"{20 * np.log10(limit):.2f} dB)")
            raw = np.zeros(N * self._out_framebytes[di], np.uint8)
            dstate = [self.dither_state[dev.phys_base + i]
                      for i in range(dev.used_channels)]
            ovfs = [self._phys_overflow[dev.phys_base + i]
                    for i in range(dev.used_channels)]
            float_to_raw(rows, dev.sample_format, dev.open_channels,
                         dev.channel_selection, raw, ovfs, dstate)
            self.devices[OUT][di].write(
                raw[: frames * self._out_framebytes[di]].tobytes())

        devs = list(enumerate(conf.iodevs[OUT]))
        if len(devs) > 1 and self._encode_pool is not None:
            # devices own disjoint physical channels, so their dither and
            # overflow state never meet; every future's result is read
            list(self._encode_pool.map(lambda a: encode_one(*a), devs))
        else:
            for di, dev in devs:
                encode_one(di, dev)
        self._peak_push()

    def _read_device(self, inst, want: int, framebytes: int) -> bytes:
        """One device's fragment read; in poll mode, nanosleep-paced
        accumulation of nonblocking partial reads (engine.py:1001-1028,
        dai.c:1198-1230, the sleep tiers verbatim)."""
        if not (self._poll_mode and inst.bad_alignment):
            return inst.read(want)
        out = b""
        first = True
        while len(out) < want:
            if not first:
                usec = ((want - len(out)) // framebytes * 1_000_000
                        // self.conf.sampling_rate)
                if usec > 40000:
                    time.sleep(usec / 1e6)
                elif usec > 20000:
                    time.sleep(0.010)
                elif usec > 2050:
                    time.sleep(0.002)
                elif usec > 50:
                    time.sleep((usec - 50) / 1e6)
            first = False
            chunk = inst.read_nonblock(want - len(out))
            if chunk is None:
                continue
            if chunk == b"":
                break  # EOF
            out += chunk
        return out

    # ----- device-IO host side ---------------------------------------------
    def read_block_dio(self, into=None):
        """Read raw words per input device: ([N, ...] arrays, frames),
        frames < N at EOF (the block is zero padded). ``into``: per
        device a writable C-contiguous [N, ...] array (a row of the
        producer's stack) the words are read into in place and returned
        as; else new arrays."""
        N = self.N
        frames = N
        words = []
        for di, inst in enumerate(self.devices[IN]):
            fb = self._in_framebytes[di]
            if into is None:
                raw = self._read_device(inst, N * fb, fb)
                got = len(raw)
                if got < N * fb:
                    raw = raw + b"\0" * (N * fb - got)
                # the file's bytes as read, a view (see device_io.py)
                w = np.frombuffer(raw, dtype=self.dio.in_wire_dtype[di]
                                  ).reshape((N,) + self.dio.in_wire_shape[di])
            else:
                w = into[di]
                buf = w.reshape(-1).view(np.uint8)
                if self._poll_mode and inst.bad_alignment:
                    raw = self._read_device(inst, N * fb, fb)
                    got = len(raw)
                    buf[:got] = np.frombuffer(raw, np.uint8)
                else:
                    got = inst.readinto(memoryview(buf))
                buf[got:] = 0
            frames = min(frames, got // fb)
            words.append(w)
        return words, frames

    def _account_output_meters(self, dev, m: np.ndarray):
        """Fold one device's [used, 4] meter rows into the per-channel
        Overflow stats and enforce safety_limit (real2raw.h:32-42) --
        before anything is written to the device."""
        fmt = dev.sample_format
        limit = self.conf.safety_limit
        for i in range(dev.used_channels):
            ovf = self._phys_overflow[dev.phys_base + i]
            ovf.n_overflows += int(m[i, 0])
            ovf.largest = max(ovf.largest, float(m[i, 1]))
            if not fmt.is_float:
                ovf.intlargest = max(ovf.intlargest, int(m[i, 2]))
            if limit != 0.0 and float(m[i, 3]) > limit * ovf.max:
                raise EngineError(
                    f"safety limit exceeded on output "
                    f"({20 * np.log10(float(m[i, 3]) / ovf.max):.2f} > "
                    f"{20 * np.log10(limit):.2f} dB)")

    def _write_outputs(self, outs, meters, nan_ok, ready, frames):
        """Writer-thread half of a dispatch: fetch, NaN check, meters and
        safety abort, then the device writes (first ``frames`` frames),
        each from an array of the writer's pool (``Staging``). ``ready``:
        the dispatch's ``Staging.mark``, which the fetches wait for."""
        st = self.staging
        sp = REC.on and REC.begin("write.sync")
        if not bool(st.fetch(nan_ok, ready)):
            raise EngineError("NaN or Inf values in the system! "
                              "Invalid input?",
                              exit_code=BF_EXIT_INVALID_INPUT)
        for di, dev in enumerate(self.conf.iodevs[OUT]):
            sp = sp and REC.next(sp, "write.meters")
            self._account_output_meters(dev, st.fetch(meters[di], ready))
            sp = sp and REC.next(sp, "write.fetch")
            raw = st.fetch(outs[di], ready)
            sp = sp and REC.next(sp, "write.encode")
            if self.dio.out_wire[di] == "raw3":
                raw = raw.reshape(-1, dev.open_channels, 3)
            else:
                raw = raw.reshape(-1, dev.open_channels)
            data = st.encode(di, raw[:frames])
            sp = sp and REC.next(sp, "write.file")
            self.devices[OUT][di].write(data)
        sp = sp and REC.next(sp, "write.peak")
        self._peak_push()
        if sp:
            REC.end(sp)

    # ----- the writer thread and run statistics -----------------------------
    def _start_writer(self, sink_output: bool = False):
        """The output stage on its own thread (the analog of the
        reference's output process, bfrun.c:846-964): it fetches, meters
        and writes block k while the main thread dispatches block k+1.
        An item is ("dio", frames, block, blocks, outs, meters, nan_ok,
        ready) from the device-IO path or ("host", frames, block, blocks, y,
        out_snap) from the host path (``block``, ``blocks``: its first
        block and block count, the id of its spans). Returns (queue,
        stats, thread); queue depth 2 bounds latency.

        ``sink_output`` (engine.py:1159-1218): no sample leaves the card.
        The writer waits for the newest result once every
        ``BRUTEFIR_TPU_DRAIN_EVERY`` blocks (default about a second of
        audio, at least 64; the stream is in order, so that bounds the
        backlog) and at the end; on the host path it also runs
        ``write_block`` on a zero staging buffer of the block's shape, so
        the encode's cost stays real."""
        wq: "queue.Queue" = queue.Queue(maxsize=2)
        wstats = {"frames": 0, "blocks": 0, "err": None}
        default_drain = max(64, self.conf.sampling_rate // self.N)
        drain_every = max(1, int(os.environ.get(
            "BRUTEFIR_TPU_DRAIN_EVERY", str(default_drain))))
        sink = {"last": None, "n": 0}
        sink_stage = (np.zeros((self.conf.n_channels[OUT], self.N), self.rd)
                      if sink_output else None)

        def sink_drain(result):
            sink["last"] = result
            sink["n"] += 1
            if sink["n"] % drain_every == 0:
                _wait_for(sink["last"])
                sink["last"] = None

        def writer():
            while True:
                sp = REC.on and REC.begin("write.wait")
                item = wq.get()
                if item is None:
                    if sp:
                        REC.end(sp)
                    try:
                        if sink["last"] is not None:
                            _wait_for(sink["last"])
                    except Exception as e:
                        wstats["err"] = e
                    return
                kind, fk, blk, nb, *rest = item
                if sp:
                    REC.end(sp, block=(blk, nb))
                sp = REC.on and REC.begin("write", blk, nb)
                try:
                    if kind == "dio":
                        if sink_output:
                            sink_drain(rest[0])
                        else:
                            self._write_outputs(*rest, fk)
                    elif sink_output:
                        y, out_snap = rest
                        sink_drain(y)
                        self.write_block(sink_stage, fk, out_snap)
                    else:
                        y, out_snap = rest
                        # C-contiguous rows of the real type, as
                        # float_to_raw takes them: one copy off the card
                        part = REC.on and REC.begin("write.fetch")
                        y = y.contiguous().cpu().numpy()
                        if part:
                            REC.end(part)
                        self.write_block(y, fk, out_snap)
                    wstats["frames"] += fk
                    wstats["blocks"] += 1
                    if sp:
                        REC.end(sp, fk)
                except Exception as e:
                    wstats["err"] = e
                    return

        wth = threading.Thread(target=writer, daemon=True, name="bf-writer")
        wth.start()
        return wq, wstats, wth

    @staticmethod
    def _stop_writer(wq, wth):
        try:
            wq.put(None, timeout=5.0)
        except queue.Full:
            pass
        wth.join(timeout=600.0)

    def _put(self, wq, wstats, item):
        while wstats["err"] is None:
            try:
                wq.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def _stats(self, frames_out: int, elapsed: float) -> dict:
        periods = np.asarray(self._periods)
        return {
            "blocks": self.blockcounter,
            "frames": frames_out,
            "elapsed_s": elapsed,
            "xrt": (frames_out / self.conf.sampling_rate) / elapsed
            if elapsed > 0 else 0.0,
            "p50_block_ms": float(np.median(periods) * 1e3)
            if periods.size else 0.0,
            "p95_block_ms": float(np.percentile(periods, 95) * 1e3)
            if periods.size else 0.0,
            "rti_max": self._rti_max,
            "realtime_index": self.realtime_index,
            "overflows": [o.n_overflows for o in self.overflow],
            "peak_db": [o.peak_db() for o in self.overflow],
            "staging": dict(self.staging.counts),
        }

    def _teardown_quietly(self):
        try:
            self.teardown()
        except Exception:
            pass

    # ----- per-block run ---------------------------------------------------
    def run(self, max_blocks: Optional[int] = None, setup: bool = True,
            sink_output: bool = False):
        """Process block by block until input EOF (or until the engine
        has run ``max_blocks`` blocks since its first). Returns run
        statistics. ``setup=False`` neither attaches the logic modules
        nor opens or closes the devices: the caller runs ``setup()``,
        one or more runs, then ``teardown()``. ``sink_output``: the
        outputs are sinks (``/dev/null``) and no sample leaves the card
        (``_start_writer``); meters reflect the staging data."""
        if setup:
            # logic first: attach_logic may drop the device-IO path or
            # add taps, and setup()'s _warm_programs warms what runs
            self.attach_logic()
            self.setup()
        prof = self._start_profile()
        own = tracing.follow(DEBUG_SPANS if self.conf.debug else 0,
                             DEBUG_EVENTS)
        budget = self.N / self.conf.sampling_rate    # seconds per block
        t_run0 = time.perf_counter()
        # bounded: p50/p95 over the most recent ~131k blocks
        self._periods = collections.deque(maxlen=1 << 17)
        self._last_progress = t_run0
        clocked = any(inst.uses_sample_clock for inst in self.devices[IN])
        self._monitor_clock = ((t_run0, self.blockcounter)
                               if self.conf.monitor_rate and clocked
                               else None)
        self.staging.reset()
        wq, wstats, wth = self._start_writer(sink_output)
        wd_stop = self._start_watchdog()
        try:
            try:
                self._run_prefetched(max_blocks, wq, wstats, budget,
                                     sink_output)
            finally:
                wd_stop.set()
                self._stop_writer(wq, wth)
            if wstats["err"] is not None:
                raise wstats["err"]
        except BaseException:
            # finish the trace and release the devices: a caller that
            # catches the error and builds a new Engine must not inherit
            # a running profiler, a recorder left on or still-open devices
            self._stop_quietly(prof, own)
            if setup:
                self._teardown_quietly()
            raise
        if own:
            REC.disable()
        if prof is not None:
            self._stop_profile(prof)
        elapsed = time.perf_counter() - t_run0
        if self.conf.debug:
            self._dump_debug_timeline()
        if self.conf.overflow_warnings and not getattr(self.conf, "quiet",
                                                       False):
            self._print_overflow_warnings()
        stats = self._stats(wstats["frames"], elapsed)
        if setup:
            self.teardown()
        return stats

    def _start_profile(self):
        """The opt-in trace of ``run()`` and ``run_offline``
        (``BRUTEFIR_TPU_PROFILE=<dir>``, engine.py:1137-1139): a started
        ``torch.profiler.profile`` of the host and, on a card, of CUDA,
        with its directory (made as ``jax.profiler.start_trace`` makes
        it); None without the knob."""
        out = os.environ.get("BRUTEFIR_TPU_PROFILE")
        if not out:
            return None
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(out, exist_ok=True)
        prof = profile(activities=acts)
        prof.start()
        return prof, out

    @staticmethod
    def _stop_profile(prof) -> str:
        """Stop the trace of ``_start_profile`` and write it into its
        directory as one Chrome trace, ``run_<pid>_<ns>.json``, with the
        recorder's spans on each thread's track; returns its path."""
        p, out = prof
        p.stop()
        path = os.path.join(out, f"run_{os.getpid()}_{time.time_ns()}.json")
        p.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
        events = trace["traceEvents"]
        events += tracing.chrome_events(
            tracing.take(), trace.get("baseTimeNanoseconds", 0), os.getpid(),
            {e.get("tid") for e in events if e.get("name") == "thread_name"})
        with open(path, "w") as fh:
            json.dump(trace, fh)
        return path

    def _stop_quietly(self, prof, own: bool) -> None:
        """On an entry's error: the recorder off where the entry switched
        it on, the trace finished."""
        if own:
            REC.disable()
        if prof is not None:
            try:
                self._stop_profile(prof)
            except Exception:
                pass

    def _start_watchdog(self) -> threading.Event:
        """The opt-in stall watchdog (``BRUTEFIR_TPU_WATCHDOG=<seconds>``,
        engine.py:1234-1257): once the first block has run, no block for
        that long ends the process with exit code 1, as the reference
        dies on a dead device. Returns the event that disarms it."""
        wd_stop = threading.Event()
        wd_timeout = float(os.environ.get("BRUTEFIR_TPU_WATCHDOG", "0")
                           or 0.0)
        if wd_timeout > 0:
            def watchdog():
                last = (self.blockcounter, time.monotonic())
                while not wd_stop.wait(min(1.0, wd_timeout / 4)):
                    bc = self.blockcounter
                    if bc != last[0]:
                        last = (bc, time.monotonic())
                    elif (bc > 0
                          and time.monotonic() - last[1] > wd_timeout):
                        sys.stderr.write(
                            f"no block completed for {wd_timeout:.0f} s "
                            "(stalled device or transport); aborting.\n")
                        sys.stderr.flush()
                        os._exit(BF_EXIT_OTHER)

            threading.Thread(target=watchdog, daemon=True,
                             name="bf-watchdog").start()
        return wd_stop

    def _run_prefetched(self, max_blocks, wq, wstats, budget, sink_output):
        """``_run_blocks``, with the input prefetch of sink mode on the
        device-IO path (engine.py:1312-1388): a producer thread reads
        block k+1.. and a pool of 2 workers uploads them while the main
        thread dispatches block k; the queue carries the uploads' futures
        in block order, 3 deep. The producer never reads past
        ``max_blocks``, so a later run on this engine loses no input."""
        if self.dio is None or not sink_output:
            self._run_blocks(max_blocks, wq, wstats, budget)
            return
        from concurrent.futures import ThreadPoolExecutor
        N = self.N
        pq: "queue.Queue" = queue.Queue(maxsize=3)
        pstate = {"stop": False, "err": None}
        up_pool = ThreadPoolExecutor(max_workers=2,
                                     thread_name_prefix="bf-upload")

        def upload(ws, blk):
            sp = REC.on and REC.begin("upload", blk, 1)
            words = [torch.as_tensor(np.array(w), device=self.device)
                     for w in ws]
            if sp:
                REC.end(sp)
            return words

        def producer():
            try:
                left = (None if max_blocks is None
                        else max(0, max_blocks - self.blockcounter))
                blk = self.blockcounter
                while not pstate["stop"]:
                    if left is not None:
                        if left <= 0:
                            return
                        left -= 1
                    sp = REC.on and REC.begin("read", blk, 1)
                    xw, f = self.read_block_dio()
                    # the silence test on the host's words (the uploaded
                    # ones would cost a fetch)
                    item = (up_pool.submit(upload, xw, blk), f,
                            self._input_silent_words(xw))
                    sp = sp and REC.next(sp, "produce.wait", f)
                    while not pstate["stop"]:
                        try:
                            pq.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if sp:
                        REC.end(sp)
                    blk += 1
                    if f < N:
                        return
            except Exception as e:
                pstate["err"] = e
                try:
                    pq.put_nowait((None, 0, False))
                except queue.Full:
                    pass

        pth = threading.Thread(target=producer, daemon=True,
                               name="bf-producer")
        pth.start()
        try:
            self._run_blocks(max_blocks, wq, wstats, budget, pq, pstate)
        finally:
            # an error in the block loop must not leak the producer, the
            # pool or prefetched blocks
            pstate["stop"] = True
            try:
                while True:
                    pq.get_nowait()
            except queue.Empty:
                pass
            pth.join(timeout=10.0)
            up_pool.shutdown(wait=False)

    def _input_silent_words(self, xw) -> bool:
        """Powersave silence on raw input words: exact zero only (the
        analog threshold would need a decode), as the JAX package's
        device-IO path decides it; it only gates the rti meter here."""
        if not self.conf.powersave:
            return False
        # a "p24" word decodes from its low 24 bits alone
        return all(not (np.asarray(w) & 0xFFFFFF if wire == "p24"
                        else np.asarray(w)).any()
                   for w, wire in zip(xw, self.dio.in_wire))

    def _update_full_proc(self, silent: bool) -> bool:
        """Advance the full-processing ramp (procblocks,
        bfrun.c:1567-1571): rti counts only after B+1 live blocks; a
        silent block resets it (bfrun.c:1721-1722)."""
        self._procblocks = 0 if silent else min(self._procblocks + 1,
                                                self.B + 1)
        return self._procblocks > self.B

    def _run_blocks(self, max_blocks, wq, wstats, budget, pq=None,
                    pstate=None):
        N = self.N
        show = self.conf.benchmark or self.conf.debug
        quiet = getattr(self.conf, "quiet", False)
        eof = False
        epoch = None
        while not self._stopped and not eof:
            if max_blocks is not None and self.blockcounter >= max_blocks:
                break
            if wstats["err"] is not None:
                break
            # one reading of the clock a stage boundary, for the stage
            # table, the periods and the spans
            t0 = time.perf_counter()
            blk = self.blockcounter
            sp = REC.on and (
                REC.begin("read", blk, 1, t0) if pq is None
                else REC.begin("dispatch.wait_producer", blk, 1, t0))
            self._block_start_hooks()
            if pq is not None:
                fut, frames, silent = pq.get()
                if pstate["err"] is not None:
                    raise pstate["err"]
                words = fut.result() if fut is not None else []
            elif self.dio is not None:
                xw, frames = self.read_block_dio()
                silent = self._input_silent_words(xw)
                words = None
            else:
                x, frames = self.read_block()
                silent = self._input_silent(x if frames > 0 else None)
            if frames < N:
                eof = True
            t1 = time.perf_counter()
            if sp:
                REC.end(sp, frames, t1)
            item = None
            sp = frames > 0 and REC.on and REC.begin("dispatch", blk, 1, t1)
            if frames > 0:
                epoch = self._snapshot_epoch()
                ctrl, gains, uni, udl, xf, bank, out_snap = epoch
                if self.dio is not None:
                    if words is None:
                        # np.array: a writable copy of the (read-only)
                        # words
                        up = REC.on and REC.begin("upload")
                        words = [torch.as_tensor(np.array(w),
                                                 device=self.device)
                                 for w in xw]
                        if up:
                            REC.end(up)
                    self.state, outs, meters, nan_ok = self.dio.step(
                        self.state, ctrl, gains[0], gains[1], bank, words,
                        uniform=uni, udelay=udl, xfade=xf)
                    item = ("dio", frames, blk, 1, outs, meters, nan_ok,
                            self.staging.mark())
                else:
                    item = ("host", frames, blk, 1,
                            self._dispatch_host(x, epoch), out_snap)
                self.blockcounter += 1
            t2 = time.perf_counter()
            if item is not None:
                sp = sp and REC.next(sp, "dispatch.wait_writer", t=t2)
                self._put(wq, wstats, item)
            t3 = time.perf_counter()
            if sp:
                REC.end(sp, t=t3)
            period = t3 - t0
            self._periods.append(period)
            rti = period / budget
            full = self._update_full_proc(silent)
            if full:
                self.realtime_index = rti
                self._rti_max = max(self._rti_max, rti)
            self._stage_t += (t1 - t0, t2 - t1, t3 - t2, period)
            self._stage_blocks += 1
            if show and self._stage_blocks % 10 == 0:
                self._print_stage_table(epoch)
            if (self.conf.show_progress and not quiet
                    and t3 - self._last_progress > 1.0):
                # the rti echo (engine.py:1599-1607)
                self._last_progress = t3
                if full:
                    sys.stderr.write(f"rti: {rti:.3f}\n")
                else:
                    sys.stderr.write(
                        "rti: not full processing - no rti update\n")
            if self._monitor_clock is not None:
                # sample rate drift abort at +-2% (engine.py:1608-1620,
                # dai.c:1336-1369)
                w = t3 - self._monitor_clock[0]
                if w > 4.0:
                    measured = ((self.blockcounter - self._monitor_clock[1])
                                * N / w)
                    self._monitor_clock = (t3, self.blockcounter)
                    drift = measured / self.conf.sampling_rate
                    if not (0.98 < drift < 1.02):
                        raise EngineError(
                            f"sample rate drift detected: measured "
                            f"{measured:.0f} Hz, configured "
                            f"{self.conf.sampling_rate} Hz")

    def _print_stage_table(self, epoch=None):
        """The reference's benchmark table (bfrun.c:2035-2078), the JAX
        package's text: host ms a block averaged over the periods since
        the last print. With ``BRUTEFIR_TPU_STAGE_BREAKDOWN`` set, the
        device column is apportioned by the device times of one block's
        calls, taken once, at the first print, on this engine's route
        under ``epoch`` (the last block's ``_snapshot_epoch``; None: a new
        one) with its bank, taps and mesh
        (``stageprobe.device_stage_slopes``)."""
        t = self._stage_t / max(self._stage_blocks, 1) * 1e3
        if os.environ.get("BRUTEFIR_TPU_STAGE_BREAKDOWN"):
            from .stageprobe import STAGES, device_stage_slopes
            if not hasattr(self, "_stage_slopes"):
                ctrl, _, uni, udl, _, bank, _ = (epoch
                                                 or self._snapshot_epoch())
                self._stage_slopes = device_stage_slopes(
                    self.spec, bank, self.device, self.ring_dtype, ctrl,
                    uni, udl, self.taps, self.mesh)
                tot = sum(self._stage_slopes.values())
                sys.stderr.write(
                    "device stage calibration (ms/block): "
                    + " ".join(f"{k} {self._stage_slopes[k] * 1e3:.3f}"
                               for k in STAGES)
                    + f"  (sum {tot * 1e3:.3f})\n")
            sl = self._stage_slopes
            tot = sum(sl.values()) or 1.0
            parts = {k: t[1] * sl[k] / tot for k in STAGES}
            sys.stderr.write(
                f"decode {t[0]:7.3f} | "
                + " | ".join(f"{k} {parts[k]:7.3f}" for k in STAGES)
                + f" | encode {t[2]:7.3f} | total {t[3]:7.3f} | "
                f"rti {self.realtime_index:6.3f}  "
                "(ms; device split calibrated)\n")
        else:
            sys.stderr.write(
                f"decode/ms {t[0]:9.3f} | device/ms {t[1]:9.3f} | "
                f"encode/ms {t[2]:9.3f} | total/ms {t[3]:9.3f} | "
                f"rti {self.realtime_index:6.3f}\n")
        self._stage_t[:] = 0
        self._stage_blocks = 0

    def _dump_debug_timeline(self):
        """Full-ring timeline dump (print_debug, bfrun.c:230-434), the
        JAX package's text: one section per pipeline stage (input, filter,
        output), each listing every retained period's call/ret events in
        microseconds from the first retained event. The events are the
        starts and ends of the recorder's ``read``, ``dispatch`` and
        ``write`` spans, the newest ``DEBUG_SPANS`` of them: 1024 periods
        of 8 events, the reference's DEBUG_MAX ring depth."""
        events = []
        for s in [s for s in tracing.take() if s.name in DEBUG_EVENTS
                  ][-DEBUG_SPANS:]:
            stage, call, ret = DEBUG_EVENTS[s.name]
            events.append((s.start_ns, stage, call, s.block))
            events.append((s.end_ns, stage,
                           ret.format(frames=s.frames), s.block))
        if not events:
            sys.stderr.write("debug timeline: no events recorded\n")
            return
        t0 = min(e[0] for e in events)
        sys.stderr.write(
            f"\ndebug timeline ({len(events)} events; timestamps in "
            "microseconds from first retained event):\n\n")
        for stage in ("input", "filter", "output"):
            sec = [e for e in events if e[1] == stage]
            if not sec:
                continue
            sys.stderr.write(f"{stage}_process:\n")
            last_blk = None
            for ts, _, ev, blk in sec:
                if blk != last_blk:
                    sys.stderr.write(f"  period {blk}:\n")
                    last_blk = blk
                sys.stderr.write(f"    {(ts - t0) // 1000}\t{ev}\n")
            sys.stderr.write("\n")

    def _print_overflow_warnings(self):
        """Per-channel clip summary at the end of ``run()``
        (print_overflows, bfrun.c:555-587): ``channel/count/peak dB`` for
        each output channel that clipped."""
        lines = [f"{n}/{o.n_overflows}/{o.peak_db():+.2f}"
                 for n, o in enumerate(self.overflow) if o.n_overflows > 0]
        if lines:
            sys.stderr.write("Overflow warnings: " + " ".join(lines) + "\n")

    # ----- offline run -----------------------------------------------------
    def run_offline(self, max_blocks: Optional[int] = None,
                    batch_blocks: int = BATCH_BLOCKS, setup: bool = True):
        """File-to-file throughput mode: batched device dispatch.

        Freezes controls across each batch of ``batch_blocks`` blocks and
        dispatches them back to back with no host synchronisation; a
        producer thread reads and uploads batch k+1 while batch k runs,
        and a writer thread fetches and writes results. Offline only:
        block latency becomes batch_blocks * N samples. Falls back to
        ``run()`` on the host codec path (engine.py:1633), for logic
        modules (script lines pace per block) and for ``batch_blocks <=
        1``. ``max_blocks`` and ``setup`` as in ``run()``. The stats'
        ``staging`` counts how the reused host buffers (``Staging``)
        engaged."""
        if self.dio is None or self.conf.logic_modules or batch_blocks <= 1:
            return self.run(max_blocks, setup=setup)
        # taps drop the device-IO path, so they never reach the batches
        # (group_step_impl has no tap sites)
        assert not self.taps
        if setup:
            self.setup()
        conf = self.conf
        N = self.N
        M = batch_blocks
        prof = self._start_profile()
        own = tracing.follow()
        t_run0 = time.perf_counter()
        self._periods = collections.deque(maxlen=1 << 17)
        self.staging.reset()
        wq, wstats, wth = self._start_writer()

        # batch producer: reads batch k+1 into its stacks in place and
        # uploads them while the main thread dispatches batch k
        pq: "queue.Queue" = queue.Queue(maxsize=2)
        pstate = {"stop": False, "err": None}
        staging = self.staging
        layout = tuple(((M, N) + self.dio.in_wire_shape[di],
                        self.dio.in_wire_dtype[di])
                       for di in range(len(conf.iodevs[IN])))

        def producer():
            try:
                # never read past max_blocks: over-read input would be
                # dropped, skipping samples for a later run on this engine
                left = (None if max_blocks is None
                        else max(0, max_blocks - self.blockcounter))
                blk = self.blockcounter
                while not pstate["stop"]:
                    take = M if left is None else min(M, left)
                    if take == 0:
                        return
                    # one span for the batch's reads into the rows of its
                    # stacks (a pinned set waited for first); a short batch
                    # runs block by block, so rows past its end, stale in
                    # a reused set, are never read
                    sp = REC.on and REC.begin("read", blk, take)
                    stacks, pset = staging.stacks(layout)
                    got = 0
                    frames = take * N
                    hit_eof = False
                    for b in range(take):
                        _, f = self.read_block_dio(
                            into=[st[b] for st in stacks])
                        got += 1
                        if f < N:
                            frames = b * N + f
                            hit_eof = True
                            break
                    if left is not None:
                        left -= got
                    sp = sp and REC.next(sp, "upload", frames)
                    item = (*staging.upload(stacks, pset), frames, got,
                            hit_eof)
                    sp = sp and REC.next(sp, "produce.wait")
                    while not pstate["stop"]:
                        try:
                            pq.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if sp:
                        REC.end(sp)
                    blk += got
                    if hit_eof:
                        return
            except Exception as e:
                pstate["err"] = e
                try:
                    pq.put_nowait(([], None, 0, 0, True))
                except queue.Full:
                    pass

        pth = threading.Thread(target=producer, daemon=True,
                               name="bf-producer")
        pth.start()

        try:
            try:
                self._run_offline_batches(max_blocks, M, wq, wstats, pq,
                                          pstate, N / conf.sampling_rate)
            finally:
                # always stop both pipeline threads
                pstate["stop"] = True
                try:
                    while True:
                        pq.get_nowait()
                except queue.Empty:
                    pass
                pth.join(timeout=10.0)
                self._stop_writer(wq, wth)
            if wstats["err"] is not None:
                raise wstats["err"]
        except BaseException:
            self._stop_quietly(prof, own)
            if setup:
                self._teardown_quietly()
            raise
        if own:
            REC.disable()
        if prof is not None:
            self._stop_profile(prof)
        stats = self._stats(wstats["frames"], time.perf_counter() - t_run0)
        if setup:
            self.teardown()
        return stats

    def _step_one(self, wq, wstats, epoch, words, frames: int,
                  xfade: bool):
        """Dispatch one block of a batch under ``epoch`` (a
        ``_snapshot_epoch``) and queue its ``frames`` frames."""
        ctrl, gains, uni, udl, _, bank, _ = epoch
        blk = self.blockcounter
        sp = REC.on and REC.begin("dispatch", blk, 1)
        self.state, outs, meters, nan_ok = self.dio.step(
            self.state, ctrl, gains[0], gains[1], bank, words,
            uniform=uni, udelay=udl, xfade=xfade)
        ready = self.staging.mark()
        self.blockcounter += 1
        sp = sp and REC.next(sp, "dispatch.wait_writer")
        self._put(wq, wstats,
                  ("dio", frames, blk, 1, outs, meters, nan_ok, ready))
        if sp:
            REC.end(sp)

    def _run_offline_batches(self, max_blocks, M, wq, wstats, pq, pstate,
                             budget):
        N = self.N
        eof = False
        while not self._stopped and not eof and wstats["err"] is None:
            rem = (None if max_blocks is None
                   else max_blocks - self.blockcounter)
            if rem is not None and rem <= 0:
                break
            # one reading of the clock at each end of a batch, for the
            # periods and the spans
            t0 = time.perf_counter()
            sp = REC.on and REC.begin("dispatch.wait_producer",
                                      self.blockcounter, M, t0)
            dstacks, ready, frames, got_blocks, eof = pq.get()
            if sp:
                REC.end(sp)
            if pstate["err"] is not None:
                raise pstate["err"]
            self.staging.consume(dstacks, ready)
            if rem is not None and rem < got_blocks:
                got_blocks = rem
                frames = min(frames, rem * N)
            if eof or got_blocks < M or frames < M * N:
                # EOF or a max_blocks tail inside the batch: finish the
                # blocks read one at a time so no samples are dropped, a
                # snapshot per block (a pending swap crossfades only its
                # first block, as in run())
                left = frames if frames < M * N else got_blocks * N
                for b in range(got_blocks):
                    f = min(N, left - b * N)
                    if f <= 0:
                        break
                    epoch = self._snapshot_epoch()
                    self._step_one(wq, wstats, epoch,
                                   [st[b] for st in dstacks], f, epoch[4])
                break
            epoch = self._snapshot_epoch()
            start = 0
            while epoch[4] and start < M:
                # a coefficient swap landed before this batch: each
                # crossfade applies to ONE block per snapshot (the
                # reference crossfades where prevcoeff != coeff, and the
                # next snapshot clears it, bfrun.c:1695-1777). Dispatch
                # crossfade blocks one at a time until a snapshot comes
                # back without one, then run the rest under that snapshot
                self._step_one(wq, wstats, epoch,
                               [st[start] for st in dstacks], N, True)
                start += 1
                if start == M:
                    # the batch ended on a crossfade block: no further
                    # snapshot here, since snapshot() advances prev_coeff
                    # and a swap pending now would lose its crossfade;
                    # the next batch's snapshot picks it up
                    break
                epoch = self._snapshot_epoch()
            sp = False
            if start == 0:
                ctrl, gains, uni, udl, _, bank, _ = epoch
                k = self.blockcounter
                sp = REC.on and REC.begin("dispatch", k, M)
                self.state, outs, meters, nan_ok = self.dio.multi_step(
                    self.state, ctrl, gains[0], gains[1], bank,
                    dstacks, uniform=uni, udelay=udl)
                ready = self.staging.mark()
                self.blockcounter += M
                sp = sp and REC.next(sp, "dispatch.wait_writer")
                self._put(wq, wstats,
                          ("dio", M * N, k, M, outs, meters, nan_ok, ready))
            else:
                # the rest of a split batch, block by block under the
                # same snapshot
                for b in range(start, M):
                    self._step_one(wq, wstats, epoch,
                                   [st[b] for st in dstacks], N, False)
            t1 = time.perf_counter()
            if sp:
                REC.end(sp, t=t1)
            per = (t1 - t0) / M
            self._periods.append(per)
            # full batches only (the offline analog of full_proc rti
            # gating, bfrun.c:1436-1445)
            self.realtime_index = per / budget
            self._rti_max = max(self._rti_max, self.realtime_index)
