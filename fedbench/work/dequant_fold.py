"""One int8 update folded into the float32 accumulator:
``acc += (w * scale_block) * code``, with one float32 scale a block of
8192 codes."""

QBLOCK = 8192


def work(elems: int, codec: str) -> dict:
    if codec != "int8":
        raise ValueError(f"no work count for the {codec!r} codec")
    # The accumulator read and written, the codes and the scales read.
    return {"flops": 2.0 * elems, "bytes": float((4 + 4 + 1) * elems + 4 * -(-elems // QBLOCK))}
