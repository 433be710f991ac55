"""Quickstart on the PyTorch/CUDA port: the paper's gradient-output-sparsity
technique in a few lines (the twin of ``examples/quickstart.py``).

Builds a 3-layer ReLU MLP two ways — dense autograd vs the fused
sparse-backprop units (output+input block skipping, work-redistribution
schedule) — and shows (1) the gradients are equal (the technique is
lossless), (2) how much compute the block bitmaps let the backward skip.
On the card the units run the hand-written kernels: the fused ReLU
encoder (K1), the work-queue builder (K2) and the compact masked GEMM (K3).

Run:  python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.cnn_training import set_full_precision
from repro_torch.core import IN_OUT_WR, relu_matmul
from repro_torch.core.sparsity import block_sparsity, relu_mask
from repro_torch.device import resolve_device


def inputs(seed: int = 0):
    """The MLP's input, weights and dead-unit bias as numpy arrays, drawn
    from ``np.random.default_rng(seed)`` as the reference script draws
    them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((128, 64)).astype(np.float32)
    ws = [(rng.standard_normal(s) / s[0] ** 0.5).astype(np.float32)
          for s in [(64, 128), (128, 128), (128, 32)]]
    # Trained ReLU nets develop dead units (the paper's WC sparsity,
    # Fig. 7c); emulate that structure via a bias so the block bitmaps
    # have teeth.
    bias = np.zeros((128,), np.float32)
    bias[64:] = -6.0
    return x, ws, bias


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_full_precision()
    policy = IN_OUT_WR.with_(kernel_impl="pallas", block=(16, 16, 16))
    x_np, ws_np, bias_np = inputs()
    x, bias = (torch.from_numpy(a).to(dev) for a in (x_np, bias_np))

    def net_sparse(ws):
        h = x @ ws[0] + bias                # first layer: raw input
        h2 = relu_matmul(h, ws[1], policy)  # fused ReLU→GEMM, sparse bwd
        h3 = relu_matmul(h2, ws[2], policy)
        return (h3 ** 2).mean()

    def net_dense(ws):
        h = x @ ws[0] + bias
        h = torch.relu(h) @ ws[1]
        h = torch.relu(h) @ ws[2]
        return (h ** 2).mean()

    def grads(net):
        ws = [torch.from_numpy(w).to(dev).requires_grad_(True)
              for w in ws_np]
        return torch.autograd.grad(net(ws), ws)

    g_sparse = grads(net_sparse)
    g_dense = grads(net_dense)
    max_err = max(float((a - b).abs().max())
                  for a, b in zip(g_sparse, g_dense))
    print(f"max |grad_sparse - grad_dense| = {max_err:.2e}  (lossless)")

    # what the backward pass skipped: block bitmap of the ReLU footprint
    with torch.no_grad():
        h1 = x @ torch.from_numpy(ws_np[0]).to(dev) + bias
    mask = relu_mask(h1)
    bs = float(block_sparsity(mask, 16, 16))
    es = float((mask == 0).to(torch.float32).mean())
    print(f"layer-1 activation sparsity: element={es:.1%}, "
          f"16x16-block={bs:.1%}")
    print("→ the dX GEMM for layer 2 skipped "
          f"{bs:.1%} of its output tiles (exact zeros by §3.2)")
    return {"max_err": max_err, "element": es, "block": bs,
            "grads_sparse": [g.cpu() for g in g_sparse],
            "grads_dense": [g.cpu() for g in g_dense]}


if __name__ == "__main__":
    main()
