"""Times of the port's kernels through their public wrappers, on the card.

Run on a machine with a CUDA device:
  PYTHONPATH=src python -m repro_torch.kernel_times

Prints one JSON line per case: the median CUDA-event time of one wrapper
call (its host work included, as ``chip_smoke.py`` times it), the device
time of one call, captured once in a CUDA graph and replayed between two
events (a replay costs a few µs of its own), and the time the call's
kernels, memsets and copies run by the profiler's trace (``kernel_ms``, no
launch gaps).  It calls only what every slice of the port has kept
(``relu_encode``, ``bitmap_scan``, ``build_queue_kernel(bitmap,
capacity=...)``, the K3/K4 wrappers, and ``launch_args`` with the two C
launchers of the masked GEMM for the split-K reduce alone; ``queue_member``
and ``emit_nan_fixup`` where the tree has them), so the same
file times another checkout's kernels when its ``src`` comes first on the
path, which compares two trees in one call on one card:
  PYTHONPATH=<other checkout>/src python src/repro_torch/kernel_times.py
"""
from __future__ import annotations

import json
import os
import statistics
import tempfile

import torch


def event_ms(fn, reps=7, warmup=2):
    """Median CUDA-event time of one call of ``fn``, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps=50):
    """Device time of one call of ``fn``, replayed from a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps=20):
    """Device time of the kernels, memsets and copies of one call of
    ``fn``, summed from a ``torch.profiler`` trace of ``reps`` calls."""
    from repro_torch.profile_step import summarize_trace

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            busy = summarize_trace(json.load(f)["traceEvents"])["busy_ms"]
    return busy / reps


def cases(dev):
    """(name, call) at the VGG16 and MobileNet steps' shapes."""
    from repro_torch.kernels import bitmap_scan as k5
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels import queue_builder as qb
    from repro_torch.kernels import relu_encode as k1

    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for name, (m, n, gran) in (
            ("K1 VGG16 conv2 input (1, 64)", (401408, 64, (1, 64))),
            ("K1 MobileNet dw2 input (1, 1)", (100352, 64, (1, 1))),
            ("K1 MobileNet pw1 input (1, 32)", (100352, 32, (1, 32)))):
        z = torch.randn(m, n, device=dev, generator=gen)
        out.append((name, lambda z=z, g=gran: k1.relu_encode(z, g)))
    x = torch.randn(401408, 3, device=dev, generator=gen)
    out.append(("K5 MobileNet conv0 input (1, 1)",
                lambda: k5.bitmap_scan(x, (1, 1))))

    # conv4's dX GEMM: σ′ and a (1, 128) bitmap emit, ~50 % live masks.
    m, k, n, block = 100352, 1152, 128, (128, 128, 128)
    a = torch.randn(1, m, k, device=dev, generator=gen)
    b = torch.randn(1, k, n, device=dev, generator=gen)

    def mask(*shape):
        return (torch.rand(shape, device=dev, generator=gen) < 0.5) \
            .to(torch.int32)
    om, am = mask(1, m // 128, n // 128), mask(1, m // 128, k // 128)
    mult = mask(1, m, n).to(torch.float32)
    fi, jj, nl = qb.build_queue_kernel(om.reshape(-1, 1).contiguous(),
                                       capacity=om.numel())
    kw = dict(block=block, epilogue_mult=mult, emit_gran=(1, 128))
    out.append(("K3 VGG16 conv4 dX", lambda: mm
                .grouped_compact_masked_matmul_kernel(a, b, fi, jj, nl, am,
                                                      None, **kw)))
    out.append(("K4 VGG16 conv4 dX", lambda: mm.grouped_masked_matmul_kernel(
        a, b, om, am, None, **kw)))

    # A group-major compact dispatch, MobileNet dw1's dX (32 groups of
    # (100352, 9) @ (9, 1), ~50 % live tiles, sigma-prime and a (1, 1)
    # emit): its pre-pass, GEMM and fix-up.  event_ms - kernel_ms is the
    # host time of one dispatch.
    g1, m1, k1_, n1, block1 = 32, 100352, 9, 1, (128, 9, 1)
    a1 = torch.randn(m1, k1_ * g1, device=dev, generator=gen) \
        .reshape(m1, k1_, g1, 1).permute(2, 0, 1, 3).reshape(g1, m1, k1_)
    b1 = torch.randn(g1, k1_, n1, device=dev, generator=gen)
    om1 = mask(g1, m1 // 128, 1)
    mult1 = mask(g1, m1, n1).to(torch.float32)
    q1 = qb.build_queue_kernel(om1.reshape(-1, 1).contiguous(),
                               capacity=om1.numel())
    out.append(("K3 MobileNet dw1 dX (group rows, compact)", lambda: mm
                .grouped_compact_masked_matmul_kernel(
                    a1, b1, *q1, None, None, block=block1,
                    epilogue_mult=mult1, emit_gran=(1, 1))))
    # The launches around the GEMM alone, in a tree that has their
    # wrappers: the pre-pass on dw1's dX queue, the fix-up on conv4's dX.
    if hasattr(mm, "queue_member"):
        member = torch.empty(om1.numel(), dtype=torch.int32, device=dev)
        out.append(("queue_member MobileNet dw1 dX 25088 tiles",
                    lambda: mm.queue_member(*q1, member, n_cols=1)))
    if hasattr(mm, "emit_nan_fixup"):
        o4 = torch.randn(1, m, n, device=dev, generator=gen)
        bits4 = torch.ones(1, m, 1, dtype=torch.int32, device=dev)
        out.append(("emit_nan_fixup VGG16 conv4 dX (whole output)",
                    lambda: mm.emit_nan_fixup(o4, bits4, (1, 128))))

    # K2 at the steps' bitmaps: VGG16 conv2's dX queue (3,136 tiles),
    # MobileNet dw1's and dw2's (25,088 and 50,176), at full capacity and
    # below the live count.
    for name, tiles in (("VGG16 conv2 dX", 3136), ("MobileNet dw1 dX", 25088),
                        ("MobileNet dw2 dX", 50176)):
        bmp = (torch.rand((tiles, 1), device=dev, generator=gen) < 0.5) \
            .to(torch.int32)
        for cap in (tiles, int(bmp.sum()) // 2):
            out.append((f"K2 {name} {tiles} tiles cap {cap}",
                        lambda bmp=bmp, cap=cap: qb.build_queue_kernel(
                            bmp, capacity=cap)))

    # The split-K reduce alone, after one GEMM pass: VGG16 conv2's WG (79
    # partials of 576 x 64), MobileNet dw1's WG (392 partials of 32 x 9 x
    # 1, group k) and VGG16 conv9's dX (2 partials, sigma-prime and the
    # (1, 128) emit, ~50 % live tiles; with the NaN fix-up that follows an
    # emitting reduce in both trees).
    a2 = torch.randn(1, 401408, 576, device=dev, generator=gen) \
        .transpose(1, 2)
    b2 = torch.randn(1, 401408, 64, device=dev, generator=gen)
    out.append(("reduce VGG16 conv2 WG", _reduce_alone(mm, a2, b2,
                                                       (128, 128, 128))))
    adw = torch.randn(100352, 9 * 32, device=dev, generator=gen) \
        .reshape(100352, 9, 32, 1).permute(2, 0, 1, 3).reshape(32, 100352, 9) \
        .transpose(1, 2)
    bdw = torch.randn(32, 100352, 1, device=dev, generator=gen)
    out.append(("reduce MobileNet dw1 WG", _reduce_alone(mm, adw, bdw,
                                                         (9, 128, 1))))
    a9 = torch.randn(1, 6272, 4608, device=dev, generator=gen)
    b9 = torch.randn(1, 4608, 512, device=dev, generator=gen)
    om9 = mask(1, 49, 4)
    mult9 = mask(1, 6272, 512).to(torch.float32)
    out.append(("reduce VGG16 conv9 dX", _reduce_alone(
        mm, a9, b9, (128, 128, 128), om9, mult9, (1, 128))))
    # A split-K GEMM through its wrapper: conv2's WG, GEMM and reduce.
    out.append(("K4 VGG16 conv2 WG, split-K", lambda: mm
                .grouped_masked_matmul_kernel(a2, b2, None, None, None,
                                              block=(128, 128, 128))))
    # The one-call PyTorch yardsticks: torch.nonzero on K2's bitmaps and
    # torch.sum over the splits of conv2's and dw1's WG partials.
    for tiles in (3136, 50176):
        bmp = (torch.rand((tiles, 1), device=dev, generator=gen) < 0.5) \
            .to(torch.int32)

        def nonzero(bmp=bmp):
            return torch.nonzero(bmp)
        nonzero.graph = False          # it syncs: no CUDA graph holds it
        out.append((f"library torch.nonzero {tiles} tiles", nonzero))
    for name, shape in (("conv2 WG", (79, 1, 576, 64)),
                        ("dw1 WG", (392, 32, 9, 1))):
        ws = torch.randn(shape, device=dev, generator=gen)
        out.append((f"library torch.sum {name} partials",
                    lambda ws=ws: torch.sum(ws, 0)))
    return out


def _reduce_alone(mm, a, b, block, out_mask=None, mult=None, emit=None):
    """A call of the split-K reduce launch of a predicated GEMM, after one
    GEMM launch has written its partials."""
    from repro_torch.kernels import _build

    g, m, _ = a.shape
    n = b.shape[2]
    out = torch.zeros(g, m, n, device=a.device)
    bits = None if emit is None else torch.zeros(
        g, -(-m // emit[0]), -(-n // emit[1]), dtype=torch.int32,
        device=a.device)
    launch = mm.launch_args(
        mm._PREDICATED, a, b, out, bits, out_mask, None, None, mult, None,
        None, None, 0, block, emit)
    if len(launch) == 3:        # a tree with one argument list for both
        args, splits, buffers = launch
        rargs = args
    else:
        args, rargs, splits, buffers = launch
    if splits < 2:
        raise ValueError(f"{tuple(a.shape)} @ {tuple(b.shape)} is not split")
    lib = _build.load()
    _build.check(lib.masked_gemm_launch(*args), "masked_gemm")

    def call():
        # the current stream, which is the capturing one inside a graph
        _build.check(lib.masked_gemm_reduce_launch(
            *rargs[:-1], _build.stream_handle(a.device)), "reduce")
    # the launches hold raw pointers: every tensor they name stays alive
    call.buffers = (buffers, out, bits, out_mask, mult, a, b)
    return call


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    dev = torch.device("cuda", 0)
    for name, fn in cases(dev):
        print(json.dumps({"case": name, "event_ms": event_ms(fn),
                          "device_ms": graph_ms(fn)
                          if getattr(fn, "graph", True) else None,
                          "kernel_ms": kernel_ms(fn),
                          "card": torch.cuda.get_device_name(0)}),
              flush=True)


if __name__ == "__main__":
    main()
