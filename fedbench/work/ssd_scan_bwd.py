"""The SSD intra-chunk part's backward (``bwd_heads``, ``bwd_dA``,
``bwd_chunk``), counted where the decay is not zero (s <= l) as the
forward is, in the passes of 3xTF32 tensor-core products that the
gradient needs (``rate`` TF32): per (b, chunk, head) dM = dt o (dy x^T)
Q (Q + 1) P in 2 passes (x is bf16, exact in TF32) and M^T dy Q (Q + 1) P
in 3, R = B dst^T and the states' term of dB 2 Q N P each in 2; per (b,
chunk) dC and dG^T C, Q (Q + 1) N each in 2 (G = C B^T again, on the bf16
tensor cores, left out).  Reads x, B, C (``itemsize`` bytes each), dt, a_cs
and the three cotangents (float32); writes dx, dB, dC (``itemsize``), ddt
and dA (float32)."""


def work(B: int, L: int, H: int, P: int, N: int, chunk: int, itemsize: int = 2) -> dict:
    Q, C = chunk, L // chunk
    mm, pairs = Q * (Q + 1), 2 * Q * N * P
    flops = B * C * H * (5 * mm * P + 4 * pairs) + B * C * 4 * mm * N
    nbytes = (2 * B * L * H * P * itemsize + 4 * B * L * N * itemsize + 2 * B * L * H * 4 + H * 4
              + B * C * H * (2 * Q + Q * P + P * N) * 4)
    return {"flops": float(flops), "bytes": float(nbytes), "rate": "tf32"}
