"""Shape type (paddle_tpu/core/ddim.py; reference paddle/framework/
ddim.h, dim.h): a validated tuple with the reference's helper surface
(make_ddim, product, slice, with_dim, flatten_to_2d)."""

from paddle_tpu_torch.utils.error import enforce


class DDim(tuple):
    def __new__(cls, dims):
        dims = tuple(int(d) for d in dims)
        enforce(all(d >= -1 for d in dims), "bad dims %r", dims)
        return super().__new__(cls, dims)

    @property
    def rank(self):
        return len(self)

    def product(self):
        out = 1
        for d in self:
            out *= d
        return out

    def slice(self, begin, end):
        return DDim(self[begin:end])

    def with_dim(self, axis, value):
        dims = list(self)
        dims[axis] = value
        return DDim(dims)

    def __repr__(self):
        return "DDim(%s)" % (tuple(self),)


def make_ddim(*dims):
    if len(dims) == 1 and isinstance(dims[0], (tuple, list, DDim)):
        dims = dims[0]
    return DDim(dims)


def flatten_to_2d(ddim, num_col_dims):
    """Collapse dims like the reference's FC input flattening
    (cf. paddle/framework flatten semantics used by mul/fc ops)."""
    ddim = make_ddim(ddim)
    enforce(0 < num_col_dims <= ddim.rank, "num_col_dims out of range")
    row = DDim(ddim[:num_col_dims]).product()
    col = DDim(ddim[num_col_dims:]).product()
    return DDim((row, col))
