"""Small list/integer helpers mirroring reference semantics (src/Utils.hs)."""

from __future__ import annotations


def integer_log(b: int, n: int) -> int:
    """floor(log_b n); 0 for n < b (reference: src/Utils.hs:83-84)."""
    if n < b:
        return 0
    return 1 + integer_log(b, n // b)


def base_digits(b: int, n: int) -> list[int]:
    """Digits of n in base b, most-significant first; [] for n == 0
    (reference: src/Utils.hs:86-88)."""
    out = []
    while n != 0:
        n, r = divmod(n, b)
        out.append(r)
    out.reverse()
    return out


def pad_left(n: int, z, xs: list) -> list:
    return [z] * (n - len(xs)) + xs


def pad_right(n: int, z, xs: list) -> list:
    return (xs + [z] * n)[:n]


def powers(a, n: int, start=None) -> list:
    """[start, start*a, start*a^2, ...] of length n (start defaults to 1)."""
    out = []
    cur = start if start is not None else type(a)(1) if hasattr(a, "P") else 1
    for _ in range(n):
        out.append(cur)
        cur = cur * a
    return out


def powers1(a, n: int) -> list:
    """powers' = [a, a^2, ...] of length n (reference: src/Utils.hs:107-108)."""
    return powers(a, n, start=a)


def pairs(xs: list) -> list:
    """Adjacent pairs, dropping a trailing odd element
    (reference: src/Utils.hs:94-97)."""
    return [(xs[i], xs[i + 1]) for i in range(0, len(xs) - 1, 2)]


def unpairs(ps: list) -> list:
    out = []
    for a, b in ps:
        out.append(a)
        out.append(b)
    return out


def chunks(n: int, xs: list) -> list:
    return [xs[i : i + n] for i in range(0, len(xs), n)]


def de_dup(xs: list) -> list:
    """Sorted unique elements (reference: src/Utils.hs:219-220)."""
    return sorted(set(xs))


def approx_log_w(n: int) -> int:
    """Default digit base ~ log(n)/loglog(n) (reference: app/Parse.hs:195-199)."""
    l = integer_log(2, n)
    ll = integer_log(2, l)
    return l // ll


def insert_at(n: int, x, xs: list) -> list:
    return xs[:n] + [x] + xs[n:]


def remove_at(n: int, xs: list) -> list:
    return xs[:n] + xs[n + 1 :]


def split_at_maybe(n: int, xs: list):
    if len(xs) < n:
        return None
    return xs[:n], xs[n:]


def take_maybe(n: int, xs: list):
    if len(xs) < n:
        return None
    return xs[:n]


def drop_if(flags: list, xs: list) -> list:
    return [x for f, x in zip(flags, xs) if not f]


def replace_if(flags: list, y, xs: list) -> list:
    return [y if f else x for f, x in zip(flags, xs)]


def zip_with_def(f, x0, y0, xs: list, ys: list) -> list:
    """zipWithDef'': pad both lists to max length with defaults
    (reference: src/Utils.hs:186-189)."""
    n = max(len(xs), len(ys))
    return [
        f(xs[i] if i < len(xs) else x0, ys[i] if i < len(ys) else y0) for i in range(n)
    ]


def sums(xss: list) -> list:
    """Elementwise sum of ragged lists, zero-extended
    (reference: src/Utils.hs:227-228)."""
    n = max((len(xs) for xs in xss), default=0)
    out = [0] * n
    for xs in xss:
        for i, x in enumerate(xs):
            out[i] = out[i] + x
    return out
