"""The curve walk's least work a call (csrc/curve_intersect.cu in the
program), counted so that it depends on neither the cull nor the kernel:
the rays read (origin, direction, tmin, tmax: 32 bytes a ray), their
closest line and point written (index, t, u, v; index, t: 24 bytes), the
element table read once (32 bytes an element), and one line test (71
fp32 operations) and one point test (29) a ray. A floor: the walk tests
every candidate its warp reaches. The least time on an H100 SXM is the
larger of the bytes at 3.35 TB/s and the operations at 67 TFLOP/s."""

RAY_BYTES = 32
HIT_BYTES = 24
ELEM_BYTES = 32
LINE_OPS = 71
POINT_OPS = 29
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def cost(rays: int, elements: int) -> tuple[float, float]:
    """(bytes, operations) of calls over `rays` rays in all, whose element
    tables hold `elements` elements in all (one table read a call)."""
    return (rays * (RAY_BYTES + HIT_BYTES) + elements * ELEM_BYTES,
            rays * (LINE_OPS + POINT_OPS))


def bound_s(rays: int, elements: int) -> float:
    """The least seconds on the card for that work."""
    n_bytes, ops = cost(rays, elements)
    return max(n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S)
