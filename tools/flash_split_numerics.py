"""Why the f32 flash kernels split the score product into TF32 and the
rest into bf16 (the forward, K1/K2, in
dnn_tpu_torch/ops/cuda/csrc/flash_attention.cu; the backward, K3/K4, in
csrc/flash_backward.cu). An emulation in numpy of the kernels' products
on split operands, against float64: each operand x is split into hi +
lo (bf16: hi = bf16(x), lo = bf16(x - hi); TF32: the same with
round-to-nearest TF32), a product is hi.hi + hi.lo + lo.hi with exact
multiplies and float64 sums (the tensor cores' truncating accumulation
is not emulated), and P, dS are split in the same way for the second
products. With q and k x 4 (scores of tens, as in trained models) an
error in the score product goes through exp: bf16 hi + lo there misses
the 1e-4 limit the kernels are held to, 3xTF32 meets it. Prints, at q,
k x 1, 3 and 4 (D = 64, T = S = 512, causal, one head, seed 0), for the
forward max |error| of O and of the logsumexp, and for the backward max
|error| / max |gradient| of dQ, dK and dV, for each mix: the tables
quoted in the kernel sources. Runs on the CPU in seconds; no card, no
JAX, no torch.

    python tools/flash_split_numerics.py
"""

import math

import numpy as np


def round_bf16(x):
    """float32 -> the nearest bf16 value (ties to even), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def round_tf32(x):
    """float32 -> the nearest TF32 value (ties away from zero), as
    cvt.rna.tf32.f32 rounds, as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x1000) & 0xFFFFE000
    return b.astype(np.uint32).view(np.float32)


SPLITS = {"bf16": round_bf16, "tf32": round_tf32}


def split(x, kind):
    hi = SPLITS[kind](x)
    return hi, SPLITS[kind](np.float32(x) - hi)


def product(a, b, kind, eq):
    """einsum `eq` of float32 a and b through hi + lo splits: hi.hi +
    hi.lo + lo.hi in float64; kind None is the plain float64 product."""
    if kind is None:
        return np.einsum(eq, a.astype(np.float64), b.astype(np.float64))
    (ah, al), (bh, bl) = split(a, kind), split(b, kind)
    f = [t.astype(np.float64) for t in (ah, al, bh, bl)]
    return (np.einsum(eq, f[0], f[2]) + np.einsum(eq, f[0], f[3])
            + np.einsum(eq, f[1], f[2]))


def forward(q, k, v, score, rest):
    """O and the logsumexp of causal attention for one head, the score
    product split as `score`, P.V as `rest` (P = exp(s - row max) rounded
    to float32 first, O = P.V / rowsum(P), as the kernel divides at the
    end); None = float64 throughout."""
    t, d = q.shape
    keep = np.tril(np.ones((t, k.shape[0]), bool), k.shape[0] - t)
    s = product(q, k, score, "td,sd->ts") / math.sqrt(d)
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    if rest is not None:
        p = p.astype(np.float32)
    return product(p, v, rest, "ts,sd->td") / l, np.log(l[:, 0]) + m[:, 0]


def forward_errors(score, rest, t=512, d=64, qk_scale=4.0, seed=0):
    """max |error| of (O, lse) against float64."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((t, d)).astype(np.float32)
               for _ in range(3))
    q, k = (np.float32(qk_scale) * x for x in (q, k))
    want = forward(q, k, v, None, None)
    got = forward(q, k, v, score, rest)
    return [float(np.abs(g - w).max()) for g, w in zip(got, want)]


def backward(q, k, v, do, score, rest):
    """dQ, dK, dV of causal attention for one head, the score product
    split as `score`, every other product (dP, dQ, dK, dV; P and dS
    rounded to float32 first) as `rest`; None = float64 throughout."""
    t, d = q.shape
    scale = 1.0 / math.sqrt(d)
    keep = np.tril(np.ones((t, k.shape[0]), bool), k.shape[0] - t)
    s64 = np.einsum("td,sd->ts", q.astype(np.float64), k.astype(np.float64))
    s64 = np.where(keep, s64 * scale, -np.inf)
    lse = np.log(np.exp(s64 - s64.max(-1, keepdims=True)).sum(-1)) \
        + s64.max(-1)
    o = np.exp(s64 - lse[:, None]) @ v.astype(np.float64)
    di = (do.astype(np.float64) * o).sum(-1)
    s = product(q, k, score, "td,sd->ts") * scale
    p = np.where(keep, np.exp(s - lse[:, None]), 0.0)
    dp = product(do, v, rest, "td,sd->ts")
    ds = p * (dp - di[:, None])
    if rest is not None:
        p, ds = p.astype(np.float32), ds.astype(np.float32)
    dq = product(ds, k, rest, "ts,sd->td") * scale
    dk = product(ds, q, rest, "ts,td->sd") * scale
    dv = product(p, do, rest, "ts,td->sd")
    return dq, dk, dv


def relative_errors(score, rest, t=512, d=64, qk_scale=4.0, seed=0):
    """max |error| / max |gradient| of (dQ, dK, dV) against float64."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((t, d)).astype(np.float32)
                   for _ in range(4))
    q, k = (np.float32(qk_scale) * x for x in (q, k))
    want = backward(q, k, v, do, None, None)
    got = backward(q, k, v, do, score, rest)
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


def main():
    print("forward (K1/K2): max |error| against float64")
    for score in ("bf16", "tf32"):
        for scale in (1.0, 3.0, 4.0):
            e = forward_errors(score, "bf16", qk_scale=scale)
            print(f"score {score}, P.V bf16, q k x {scale:g}: O {e[0]:.1e} "
                  f"lse {e[1]:.1e}")
    print("backward (K3/K4): max |error| / max |gradient| against float64")
    for score, rest in (("bf16", "bf16"), ("tf32", "bf16"),
                        ("tf32", "tf32")):
        for scale in (1.0, 3.0, 4.0):
            e = relative_errors(score, rest, qk_scale=scale)
            print(f"score {score}, rest {rest}, q k x {scale:g}: dQ "
                  f"{e[0]:.1e} dK {e[1]:.1e} dV {e[2]:.1e}")


if __name__ == "__main__":
    main()
