"""Log-space semirings for device DP, on torch tensors.

Counterpart of machineboss_tpu's ops/semiring.py. Two semirings
parameterize the DP engines:

  LOGSUMEXP: (+) = logaddexp, (x) = +, zero = -inf, one = 0   [Forward]
  MAXPLUS:   (+) = max,       (x) = +, zero = -inf, one = 0   [Viterbi]

The hot op is the semiring matrix product C[i,j] = (+)_k A[i,k] + B[k,j].
For LOGSUMEXP it is a real matmul after max-shifting:

  C = log( exp(A - rmax(A)) @ exp(B - cmax(B)) ) + rmax(A) + cmax(B)

exp values lie in [0,1], so the f32 matmul is numerically safe; terms more
than ~80 nats below the row/col max underflow. Products run in full
float32: the caller must not enable TF32 (PyTorch's default leaves it off
for matmuls), since chains of these products drift at reduced precision.
"""

import math

import torch

NEG_INF = -1e30  # finite stand-in for log(0); avoids inf-inf NaNs


def _safe(mx):
    # a Python scalar operand launches no fill kernel of its own
    return torch.where(mx > NEG_INF / 2, mx, 0.0)


class LogSemiring:
    name = "logsumexp"

    @staticmethod
    def add(a, b):
        return torch.logaddexp(a, b)

    @staticmethod
    def reduce(x, axis=-1):
        return torch.logsumexp(x, dim=axis)

    @staticmethod
    def prepare(b):
        """b (...,k,n) made ready for repeated products with it: its
        column-shifted exponentials and the shifts (...,1,n), as matmul
        computes them."""
        bsafe = _safe(b.max(dim=-2, keepdim=True).values)     # (...,1,n)
        return torch.exp(b - bsafe), bsafe

    @staticmethod
    def matmul_prepared(a, prep):
        """matmul(a, b) with prep = prepare(b): the same operations."""
        eb, bsafe = prep
        asafe = _safe(a.max(dim=-1, keepdim=True).values)     # (...,m,1)
        prod = torch.matmul(torch.exp(a - asafe), eb)
        c = torch.log(torch.clamp(prod, min=torch.finfo(a.dtype).tiny)) \
            + asafe + bsafe
        return torch.where(prod > 0, c, NEG_INF)

    @staticmethod
    def matmul(a, b):
        """(...,m,k) x (...,k,n) -> (...,m,n) via shifted real matmul."""
        return LogSemiring.matmul_prepared(a, LogSemiring.prepare(b))

    @staticmethod
    def vecmat(v, m):
        """(...,k) x (...,k,n) -> (...,n)."""
        return LogSemiring.matmul(v[..., None, :], m)[..., 0, :]

    @staticmethod
    def vecmat_prepared(v, prep):
        return LogSemiring.matmul_prepared(v[..., None, :], prep)[..., 0, :]

    @staticmethod
    def matvec(m, v):
        return LogSemiring.matmul(m, v[..., :, None])[..., 0]

    @staticmethod
    def matmul_small(a, b):
        """Semiring matmul expanded elementwise over the contraction dim,
        for tiny k (a transducer's 2-4 states)."""
        z = a[..., :, :, None] + b[..., None, :, :]
        m = z.max(dim=-2).values
        msafe = _safe(m)
        s = torch.exp(z - msafe[..., None, :]).sum(dim=-2)
        return torch.where(m > NEG_INF / 2, torch.log(s) + msafe,
                           NEG_INF)

    @staticmethod
    def vecmat_small(v, m):
        z = v[..., :, None] + m
        mx = z.max(dim=-2).values
        msafe = _safe(mx)
        s = torch.exp(z - msafe[..., None, :]).sum(dim=-2)
        return torch.where(mx > NEG_INF / 2, torch.log(s) + msafe,
                           NEG_INF)

    zero = NEG_INF
    one = 0.0


# elements of max-plus matmul's (...,m,k,n) temporary taken at once (1 GiB
# of float32); a 1D assoc product's first level at S=65, n=16384 has 2.2e9
MAXPLUS_TEMP_ELEMS = 1 << 28


def _maxplus_matmul(a, b):
    # (...,m,k,1) + (...,1,k,n) -> max over k
    return (a[..., :, :, None] + b[..., None, :, :]).max(dim=-2).values


class MaxSemiring:
    name = "maxplus"

    @staticmethod
    def add(a, b):
        return torch.maximum(a, b)

    @staticmethod
    def reduce(x, axis=-1):
        return x.max(dim=axis).values

    @staticmethod
    def matmul(a, b):
        """(...,m,k) x (...,k,n) -> (...,m,n): the max over k of the
        (...,m,k,n) sums. Eager torch materialises those sums, so past
        MAXPLUS_TEMP_ELEMS of them the leading batch is taken in chunks
        (bit-equal: a max is exact in any grouping)."""
        m, k = a.shape[-2:]
        n = b.shape[-1]
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        per = m * k * n
        count = math.prod(batch)
        if count * per <= MAXPLUS_TEMP_ELEMS or count == 1:
            return _maxplus_matmul(a, b)
        a = a.expand(batch + (m, k)).reshape(count, m, k)
        b = b.expand(batch + (k, n)).reshape(count, k, n)
        step = max(1, MAXPLUS_TEMP_ELEMS // per)
        return torch.cat([_maxplus_matmul(a[i:i + step], b[i:i + step])
                          for i in range(0, count, step)]
                         ).reshape(batch + (m, n))

    @staticmethod
    def vecmat(v, m):
        return (v[..., :, None] + m).max(dim=-2).values

    @staticmethod
    def prepare(b):
        return b

    matmul_prepared = matmul
    vecmat_prepared = vecmat

    @staticmethod
    def matvec(m, v):
        return (m + v[..., None, :]).max(dim=-1).values

    # max-plus matmul is already the elementwise broadcast form
    @staticmethod
    def matmul_small(a, b):
        return MaxSemiring.matmul(a, b)

    @staticmethod
    def vecmat_small(v, m):
        return MaxSemiring.vecmat(v, m)

    zero = NEG_INF
    one = 0.0


class ProbSemiring:
    """Scaled-probability execution of the log semiring.

    Values are probabilities relative to a caller-carried per-item log
    scale; (+) is real +, (x) by a log constant is exp(const) * x, and the
    semiring matmul takes the LOG matrix and exps it internally. The
    caller must renormalize its carry periodically and accumulate log
    scales; values more than ~87 nats below the carry scale flush to
    zero, far below the 0.01-nat device contract."""

    name = "prob"

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def reduce(x, axis=-1):
        return x.sum(dim=axis)

    @staticmethod
    def matmul(a, b_log):
        return torch.matmul(a, torch.exp(b_log))

    @staticmethod
    def vecmat(v, m_log):
        return ProbSemiring.matmul(v[..., None, :], m_log)[..., 0, :]

    @staticmethod
    def prepare(b_log):
        return torch.exp(b_log)

    @staticmethod
    def matmul_prepared(a, eb):
        return torch.matmul(a, eb)

    @staticmethod
    def vecmat_prepared(v, eb):
        return torch.matmul(v[..., None, :], eb)[..., 0, :]

    @staticmethod
    def matvec(m_log, v):
        # note: first arg is the LOG matrix, second the prob vector
        return torch.matmul(torch.exp(m_log), v[..., :, None])[..., 0]

    @staticmethod
    def cx(c_log, x):
        """(x) by a log-space constant."""
        return torch.exp(torch.as_tensor(c_log)) * x

    @staticmethod
    def matmul_small(a, b_log):
        return (a[..., :, :, None] * torch.exp(b_log)[..., None, :, :]) \
            .sum(dim=-2)

    @staticmethod
    def vecmat_small(v, m_log):
        return (v[..., :, None] * torch.exp(m_log)).sum(dim=-2)

    zero = 0.0
    one = 1.0


# (x) by a log constant in the native log semirings is just +
LogSemiring.cx = staticmethod(lambda c, x: c + x)
MaxSemiring.cx = staticmethod(lambda c, x: c + x)

LOGSUMEXP = LogSemiring
MAXPLUS = MaxSemiring
PROB = ProbSemiring


def get_semiring(name):
    if name in ("logsumexp", "sum", "forward"):
        return LOGSUMEXP
    if name in ("maxplus", "max", "viterbi"):
        return MAXPLUS
    raise ValueError("Unknown semiring %r" % name)


def associative_scan(op, elems, dim=0):
    """Inclusive scan of `elems` along `dim` under an associative `op`:
    out[i] = elems[0] op elems[1] op ... op elems[i], the earlier operand
    on the left (torch has no lax.associative_scan). Hillis-Steele:
    ceil(log2 n) levels, each one batched `op` over the shifted operands,
    O(n log n) work."""
    x = elems.movedim(dim, 0)
    n = x.shape[0]
    step = 1
    while step < n:
        x = torch.cat([x[:step], op(x[:-step], x[step:])], dim=0)
        step *= 2
    return x.movedim(0, dim)


def fold_pairwise(op, elems, dim=0):
    """elems[0] op elems[1] op ... op elems[n-1] along `dim` by a pairwise
    tree (n a power of two, the earlier operand on the left): log2 n
    batched `op` levels. Callers pad with the identity."""
    x = elems.movedim(dim, 0)
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError("fold_pairwise needs a power-of-two length, not %d"
                         % n)
    while x.shape[0] > 1:
        x = op(x[0::2], x[1::2])
    return x[0]
