"""Operations and bytes of the port's kernels, from their inputs (frozen
copies of chip_smoke.py's count functions)."""

from __future__ import annotations

import numpy as np


def render_work(kept, rows: int, width: int, n_prims: int,
                tile: tuple[int, int]):
    """B4's operations and bytes on a call's inputs. kept is the plain
    tile cull's (E, [F,] TY, TX, K) survivors of the tiles (TILE_H,
    TILE_W); a pixel costs 60 operations (its ray, the ground plane, the
    depth) and 35 for each primitive it tests, the survivors of its tile.
    The bytes read each pose and each env's table of n_prims once and
    write each pixel."""
    th, tw = tile
    h = np.minimum(th, rows - np.arange(0, rows, th))
    w = np.minimum(tw, width - np.arange(0, width, tw))
    per_tile = kept.sum(-1).double().cpu().numpy()
    flops = float((h[:, None] * w[None, :] * (60 + 35 * per_tile)).sum())
    n_pose = int(np.prod(kept.shape[:-3]))
    nbytes = (n_pose * (3 + 4 + rows * width)
              + kept.shape[0] * n_prims * 8) * 4
    return flops, nbytes


def givens_flops(lbw: int, n: int = 18, d: int = 2, fill: int = 6) -> int:
    """Floating-point operations of one band-restricted Givens solve of
    n = 6M rows (18 at M = 3)."""
    f = 0
    for c in range(n):
        for _ in range(c + 1, min(c + lbw + 1, n)):
            f += 7 + 6 * ((min(c + fill + 1, n) - c) + d)
        f += d * (2 * (min(c + fill + 1, n) - c - 1) + 1)
    return f


def givens_bytes(n: int, lbw: int, count: int, d: int = 2,
                 fill: int = 6) -> int:
    """Bytes that count band solves of n = 6M rows must move: of each row r
    of a problem's dense aug (n, n + d) only its band, columns r - lbw ..
    r + fill - lbw, and its d right-hand sides, counted as the 32 B
    sectors they touch (the problems back to back), and the n x d solution
    written once."""
    r, j = np.arange(n)[:, None], np.arange(n + d)[None, :]
    need = (j >= n) | ((j >= r - lbw) & (j <= r + fill - lbw))
    at = np.arange(count)[:, None] * (n * (n + d)) \
        + np.nonzero(need.ravel())[0][None, :]
    return int(np.unique(at * 4 // 32).size) * 32 + count * n * d * 4


def objective_flops(K: int, dist_flops, grad: bool, M: int = 3):
    """Operations of one objective evaluation per problem (M pieces, K
    samples each): the system build and solve, the energy quadrature (3M
    nodes), and per sample the polynomial, the hinges and dist_flops for
    the distance query (~20 per live primitive of the scene SDF, ~25 for
    four window taps); with the gradient also the per-sample adjoint, the
    transposed solve and the duration chain."""
    per_sample = 50 + dist_flops + (60 if grad else 0)
    fixed = 40 * M + givens_flops(4, 6 * M) + 3 * M * 30
    if grad:
        fixed += givens_flops(2, 6 * M) + 3 * M * 30 + 50 * M
    return fixed + M * K * per_sample


def solve_flops(K: int, dist_flops, iters: np.ndarray, M: int = 3) -> float:
    """A solve spending iters iterations: one value-and-gradient per
    iteration plus the first, and at least one line-search value each."""
    return float(np.sum(objective_flops(K, dist_flops, True, M) * (1 + iters)
                        + objective_flops(K, dist_flops, False, M) * iters))
