"""FFT grid sizing shared by the PME engines.

Copy of ``ai2bmd_tpu/physics/gridutil.py``.  FFTs are fastest for 2/3/5-smooth
lengths (XLA's TPU FFT and cuFFT alike); a dimension with a larger prime
factor (e.g. the 53/59/31 the solvated Chignolin box produces from
ceil(L/spacing)) takes a slower Bluestein path.  Rounding every mesh
dimension UP to the next smooth size costs a few percent more grid points
(a strictly finer mesh, i.e. slightly MORE accurate reciprocal energies), and
both packages then use the same mesh."""


def next_smooth(n: int) -> int:
    """Smallest 2/3/5-smooth integer >= n."""
    n = max(int(n), 1)
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def smooth_grid(dims) -> tuple:
    return tuple(next_smooth(d) for d in dims)
