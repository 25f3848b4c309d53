"""Calls of the port's ten kernel functions at small shapes, each as its
wrapper and as its plain twin, for the roofline tests on the CPU
(tests/test_torch_roofline.py) and on the card (tests/test_torch_cuda.py).
Imports neither ``jax`` nor ``repro``."""
import numpy as np
import torch

from repro_torch import kernels

KERNEL_NAMES = ("ec_matmul", "ec_rmatmul", "ec_group_matmul",
                "ec_group_rmatmul", "stencil_denoise", "thomas_solve",
                "cg_update", "richardson_update", "encode_matmul",
                "encode_matmul_rng")

ENCODE = dict(sigma=0.1, levels=8)
TILE = 16


def kernel_calls(dev, seed: int = 0):
    """{name: (wrapper, plain twin, args, kwargs of the wrapper, args of
    the twin, kwargs of the twin, (flops, bytes) by hand)} on ``dev``."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dev)

    m, k, b, g, n = 40, 24, 3, 2, 56
    at, da = t(m, k), t(m, k)
    gat, gda = t(g, m, k), t(g, m, k)
    x, xt, y, yt = t(k, b), t(k, b), t(m, b), t(m, b)
    gx, gxt, gy, gyt = t(k, g * b), t(k, g * b), t(m, g * b), t(m, g * b)
    p = t(n, b)
    v = [t(n, b) for _ in range(4)]
    alpha, omega = t(b).abs(), t().abs()
    em, ek, en = 24, 32, 48
    ex, ew, eps = t(em, ek), t(ek, en), t(ek, en)
    tiles = dict(block_k=TILE, block_n=TILE)
    head = kernels.tridiag.thomas_tail(n, 1e-2, -1.0)[0]
    return {
        "ec_matmul": (kernels.ec_matmul, kernels.ec_matmul_plain,
                      (at, da, x, xt), {}, (at, da, x, xt), {},
                      (4 * m * k * b, 4 * (2 * m * k + 2 * k * b + m * b))),
        "ec_rmatmul": (kernels.ec_rmatmul, kernels.ec_rmatmul_plain,
                       (at, da, y, yt), {}, (at, da, y, yt), {},
                       (4 * m * k * b,
                        4 * (2 * m * k + 2 * m * b + k * b))),
        "ec_group_matmul": (
            kernels.ec_group_matmul, kernels.ec_group_matmul_plain,
            (gat, gda, gx, gxt), {}, (gat, gda, gx, gxt), {},
            (4 * g * m * k * b,
             4 * (2 * g * m * k + 2 * k * g * b + m * g * b))),
        "ec_group_rmatmul": (
            kernels.ec_group_rmatmul, kernels.ec_group_rmatmul_plain,
            (gat, gda, gy, gyt), {}, (gat, gda, gy, gyt), {},
            (4 * g * m * k * b,
             4 * (2 * g * m * k + 2 * m * g * b + k * g * b))),
        "stencil_denoise": (kernels.stencil_denoise,
                            kernels.stencil_denoise_plain, (p, 1e-2), {},
                            (p, 1e-2), {}, (6 * n * b, 8 * n * b)),
        "thomas_solve": (kernels.thomas_solve, kernels.thomas_solve_plain,
                         (p, 1e-2), {}, (p, 1e-2), {},
                         (5 * n * b, 4 * (2 * n * b + 2 * head))),
        "cg_update": (kernels.cg_update, kernels.cg_update_plain,
                      (*v, alpha), {}, (*v, alpha), {},
                      (4 * n * b, 4 * (6 * n * b + b))),
        "richardson_update": (kernels.richardson_update,
                              kernels.richardson_update_plain,
                              (*v[:3], omega), {}, (*v[:3], omega), {},
                              (3 * n * b, 4 * (5 * n * b + 1))),
        "encode_matmul": (kernels.encode_matmul, kernels.encode_matmul_plain,
                          (ex, ew, eps), {**ENCODE, **tiles},
                          (ex, ew, eps, ENCODE["sigma"], ENCODE["levels"],
                           TILE, TILE), {},
                          (2 * em * ek * en,
                           4 * (em * ek + 2 * ek * en + em * en))),
        "encode_matmul_rng": (kernels.encode_matmul_rng,
                              kernels.encode_matmul_rng_plain,
                              (5, ex, ew), {**ENCODE, **tiles},
                              (5, ex, ew), {**ENCODE, **tiles},
                              (2 * em * ek * en,
                               4 * (em * ek + ek * en + em * en))),
    }
