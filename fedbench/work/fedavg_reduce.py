"""The dense fold: the weighted mean of N float32 rows of L elements."""


def work(n: int, elems: int) -> dict:
    # N rows read, one row written; 2 flops an input element.
    return {"flops": 2.0 * n * elems, "bytes": 4.0 * (n + 1) * elems}
