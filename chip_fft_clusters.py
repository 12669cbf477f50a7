"""Times the fused real FFT (``csrc/fft_fused.cu``) at M = 8192 with
clusters of 8 and of 4 blocks a channel, over channel counts from 26 to
256, on one CUDA card: the measurement behind
``ops/fft_fused.cluster_size``, which takes 4 in place of 8 once C
clusters of 8 would not all be resident at once.

    python3 chip_fft_clusters.py

Needs a card and ``nvcc``; builds the kernels as ``chip_smoke.py`` does.
Each time is the median of 20 calls with the L2 cache flushed by a read
before each (``chip_smoke.time_ms``, ``read_flush``); each output is held against the plain version
first (1e-5 of its peak).
"""

from __future__ import annotations

import sys

import chip_smoke as cs

M = cs.FFT_M
CHANNELS = (26, 64, 128, 192, 256)


def launch(lib, tf, direction: str, src, S: int):
    """One launch of ``bf_fft_fused_<direction>`` with clusters of S."""
    import torch
    dev = src.device
    C = src.numel() // (2 * M)
    tables = (tf._stage_twiddles(M, dev).data_ptr(),
              tf._row_twiddles(M, dev).data_ptr(),
              tf._ab_rows(M, direction == "fwd", dev).data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if direction == "fwd":
        out = torch.empty(C, 2, M, device=dev)
        rc = lib.bf_fft_fused_fwd(src.data_ptr(), *tables, out.data_ptr(),
                                  None, C, M, S, stream)
    else:
        out = torch.empty(C, M, device=dev)
        rc = lib.bf_fft_fused_inv(src.data_ptr(), *tables, out.data_ptr(),
                                  None, C, M, M // 2, S, stream)
    if rc != 0:
        cs.fail(f"fft_fused_{direction} with clusters of {S}: cudaError {rc}")
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a card")
    from brutefir_tpu_torch.ops import _build, fft_fused as tf
    print(cs.card_line(), flush=True)
    lib = _build.load("fft_fused")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = cs.read_flush()
    for C in CHANNELS:
        x, p = cs.fft_inputs(C, cs.SEED + 20 + C)
        for direction, src, plain in (
                ("fwd", x, lambda: tf.rfft_planes_fused_reference(x)),
                ("inv", p, lambda: tf.irfft_planes_fused_reference(
                    p, M // 2).reshape(C, M))):
            ref = plain()
            times = []
            for S in (8, 4):
                got = launch(lib, tf, direction, src, S)
                cs.check(f"fft_fused_{direction} S={S}", got, ref, f"C={C}")
                times.append(cs.time_ms(
                    lambda: launch(lib, tf, direction, src, S), cs.REPS,
                    flush) * 1e3)
            print(f"C={C} {direction}: clusters of 8 {times[0]:.1f} us, of 4 "
                  f"{times[1]:.1f} us; cluster_size takes "
                  f"{tf.cluster_size(M, C, sms)} ({sms} SMs)", flush=True)
    return None


if __name__ == "__main__":
    sys.exit(main())
