"""The SSD scan's intra-chunk part, forward (``ssd_intra``): per (b,
chunk, head) y = (L o C B^T)(x dt), Q (Q + 1) P where the decay is not
zero (s <= l), and the chunk's state B^T (x dt decay), 2 Q P N; per (b,
chunk) the scores C B^T, Q (Q + 1) N; float32 products (``rate``).
Reads x, B, C (``itemsize`` bytes each) and dt (float32); writes y, the
states and the decays' cumulative sums a_cs, float32.  The state
recurrence between chunks and the carried-state term are not counted."""


def work(B: int, L: int, H: int, P: int, N: int, chunk: int, itemsize: int = 2) -> dict:
    Q, C = chunk, L // chunk
    flops = B * C * H * (Q * (Q + 1) * P + 2 * P * N * Q) + B * C * Q * (Q + 1) * N
    nbytes = ((B * L * H * P + 2 * B * L * N) * itemsize + B * L * H * 4
              + B * C * H * (Q * P + P * N + Q) * 4)
    return {"flops": float(flops), "bytes": float(nbytes), "rate": "float32"}
