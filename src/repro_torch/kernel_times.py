"""Times of the port's kernels through their public wrappers, on the card.

Run on a machine with a CUDA device:
  PYTHONPATH=src python -m repro_torch.kernel_times

Prints one JSON line per case: the median CUDA-event time of one wrapper
call (its host work included, as ``chip_smoke.py`` times it) and the device
time of one call, captured once in a CUDA graph and replayed between two
events.  It calls only wrappers whose signatures every slice of the port
has kept (``relu_encode``, ``bitmap_scan``, the K3/K4 launches), so the
same file times another checkout's kernels when its ``src`` comes first on
the path, which compares two trees in one call on one card:
  PYTHONPATH=<other checkout>/src python src/repro_torch/kernel_times.py
"""
from __future__ import annotations

import json
import statistics

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
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    dev = torch.device("cuda", 0)
    for name, fn in cases(dev):
        print(json.dumps({"case": name, "event_ms": event_ms(fn),
                          "device_ms": graph_ms(fn),
                          "card": torch.cuda.get_device_name(0)}),
              flush=True)


if __name__ == "__main__":
    main()
