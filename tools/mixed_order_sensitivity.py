"""How far the mixed plain versions of rows 6 and 8 move when only the
order of their fp32 sums changes, on the CPU: the spread that any two
correct implementations of the same roundings can show against each other.

    python tools/mixed_order_sensitivity.py [--seeds N] [--device cuda]

For the (T, R, C, H) shapes of `tests/test_torch_port_cuda.py`'s
`SEQ_SHAPES` that run on the CPU in seconds, both mixed (x, weights) pairs
and seeds 0..N-1 (the test's `_seq_case` draws), runs `lstm_seq_fwd_ref`
and `blstm_seq_fwd_ref` three times: as they are (the BLAS's order: MKL's
on the CPU, cuBLAS's on the card), with every matrix product summed input
by input in fp32 (the order of a kernel that walks k in turn), and with
every product summed in fp64 and rounded once (the correctly rounded fp32
product). Prints one line a case and order: the worst max-abs error over
the peak of (y, gates, c) against the plain version as it is, which the
card's mixed bar (1e-2 of the peak, `test_seq_kernels_match_plain`) holds
a kernel to.
With bf16 weights the products are exact and the two agree; with fp32
weights a product of a bf16 and an fp32 value is rounded, a sum in
another order moves some bf16 roundings, and the recurrence carries that
on.
"""
import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (T, R, C, H), as tests/test_torch_port_cuda.py's SEQ_SHAPES
SHAPES = {"ragged": (13, 37, 32, 64), "narrow": (11, 5, 8, 8),
          "c24": (13, 37, 24, 64), "c16": (13, 37, 16, 64)}
PAIRS = {"bf16": (torch.bfloat16, torch.bfloat16),
         "bf16_fp32w": (torch.bfloat16, torch.float32)}


def case(shape, seed, wdt, dev):
    """The operands of `_seq_case` (the same draws, in the same order)."""
    t_len, r, c, h = shape

    def draws(s):
        rng = np.random.default_rng(s)

        def draw(*dims, scale=1.0):
            return torch.from_numpy(
                (rng.standard_normal(dims) * scale).astype(np.float32)).to(dev)

        return dict(w_ih=draw(c, 4 * h, scale=0.3),
                    w_hh=draw(h, 4 * h, scale=0.3),
                    b=draw(4 * h, scale=0.1), x=draw(t_len, r, c),
                    h0=draw(r, h, scale=0.5), c0=draw(r, h, scale=0.5))

    a, bwd = draws(seed), draws(seed + 1)
    w = {k: a[k].to(wdt) for k in ("w_ih", "w_hh", "b")}
    wb = {k: bwd[k].to(wdt) for k in ("w_ih", "w_hh", "b")}
    return w, wb, a["x"].bfloat16(), a["h0"], a["c0"]


def sequential_mm(p, q):
    """p @ q in fp32, summed over the inputs one at a time."""
    p, q = p.float(), q.float()
    out = torch.zeros(*p.shape[:-1], q.shape[-1], device=p.device)
    for k in range(p.shape[-1]):
        out = out + p[..., k:k + 1] * q[k]
    return out


def fp64_mm(p, q):
    """p @ q summed in fp64, rounded once to fp32."""
    return (p.double() @ q.double()).float()


def rel(got, want):
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30))
               for g, w in zip(got, want))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    sys.path.insert(0, REPO)
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    torch.set_num_threads(1)
    if dev.type == "cuda":   # the plain versions' products as the card takes
        torch.backends.cuda.matmul.allow_tf32 = False
    print("on " + (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "the CPU"), flush=True)
    for name, shape in SHAPES.items():
        for pname, (_, wdt) in PAIRS.items():
            worst = {(o, r): [] for o in ("sequential", "fp64")
                     for r in (6, 8)}
            for seed in range(args.seeds):
                w, wb, x, h0, c0 = case(shape, seed, wdt, dev)
                pack = lk._blstm_pack(w, wb)
                runs = {}
                for order, mm in (("blas", lk._mm), ("sequential",
                                                     sequential_mm),
                                  ("fp64", fp64_mm)):
                    saved, lk._mm = lk._mm, mm
                    try:
                        runs[order] = (
                            lk.lstm_seq_fwd_ref(w["w_ih"], w["w_hh"],
                                                w["b"], x, h0, c0),
                            lk.blstm_seq_fwd_ref(*pack, x))
                    finally:
                        lk._mm = saved
                for order in ("sequential", "fp64"):
                    for i, row in enumerate((6, 8)):
                        worst[order, row].append(
                            rel(runs[order][i], runs["blas"][i]))
            for order in ("sequential", "fp64"):
                print(f"{name} {shape} {pname}, {order} against the BLAS's "
                      f"order: worst max-abs / peak by seed, row 6 "
                      f"{['%.2e' % e for e in worst[order, 6]]}, row 8 "
                      f"{['%.2e' % e for e in worst[order, 8]]}", flush=True)


if __name__ == "__main__":
    main()
