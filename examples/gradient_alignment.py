"""Differentiable alignment: fit a global affine motion by gradient descent.

A capability the CUDA reference cannot offer: the whole op
library is pure and differentiable, so model-based alignment is just
jax.grad + optax over the photometric error of the differentiable backward
warp (ops/warp.py) — no solver code.  The dense pyramidal flow seeds the
optimizer (its median translation starts the affine fit inside the warp's
basin of convergence), the gradient steps then refine to sub-pixel.

Run: python examples/gradient_alignment.py  (CPU or GPU)
"""
import numpy as np

import jax
import jax.numpy as jnp
import optax

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear
from cuda_optical_flow_2_tpu.utils import io


A_SCALE = 100.0  # an optimizer step on an A-coef moves u by ~x/A_SCALE px,
# comparable to a step on the translation — without it adam's uniform
# per-param step size lets the linear terms overshoot by +-(lr * width) px.


def affine_flow(params: jax.Array, h: int, w: int) -> jax.Array:
    """(6,) scaled affine params -> dense (H, W, 2) flow:
    [u, v] = (A / A_SCALE) @ [x, y] + t."""
    a11, a12, a21, a22, tx, ty = params
    ys, xs = jnp.mgrid[0:h, 0:w]
    u = (a11 * xs + a12 * ys) / A_SCALE + tx
    v = (a21 * xs + a22 * ys) / A_SCALE + ty
    return jnp.stack([u, v], axis=-1).astype(jnp.float32)


def main():
    # Content sampled at x + shift appears to MOVE by -shift: the flow (and
    # the affine fit) should recover (-3.6, +2.2).
    true_shift = (3.6, -2.2)
    true_flow = (-true_shift[0], -true_shift[1])
    h, w = 160, 192
    base = io.synthetic_sequence(1, h + 16, w + 16, velocity=(0, 0))[0]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    prev = jnp.asarray(base[8 : 8 + h, 8 : 8 + w], jnp.float32)
    # bilinearly sample the shifted frame so the truth is sub-pixel exact
    sx, sy = xs + true_shift[0] + 8, ys + true_shift[1] + 8
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    nxt = jnp.asarray(
        base[y0, x0] * (1 - fx) * (1 - fy)
        + base[y0, x0 + 1] * fx * (1 - fy)
        + base[y0 + 1, x0] * (1 - fx) * fy
        + base[y0 + 1, x0 + 1] * fx * fy,
        jnp.float32,
    )

    # Seed: median of the dense pyramidal flow (coarse but in-basin).
    dense = of.pyramidal_lk(
        prev, nxt, of.LKConfig(levels=3, window=11, use_pallas=False)
    )
    seed = jnp.median(dense[16:-16, 16:-16].reshape(-1, 2), axis=0)
    params = jnp.array([0.0, 0.0, 0.0, 0.0, seed[0], seed[1]], jnp.float32)
    print(f"dense-flow seed: ({float(seed[0]):+.3f}, {float(seed[1]):+.3f})"
          f"  truth: ({true_flow[0]:+.3f}, {true_flow[1]:+.3f})")

    def loss(p):
        warped = warp_bilinear(nxt, affine_flow(p, h, w))
        # crop the border the warp clamps at
        return jnp.mean((warped[8:-8, 8:-8] - prev[8:-8, 8:-8]) ** 2)

    opt = optax.adam(5e-2)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        val, g = jax.value_and_grad(loss)(params)
        updates, state = opt.update(g, state)
        return optax.apply_updates(params, updates), state, val

    for i in range(400):
        params, state, val = step(params, state)
    tx, ty = float(params[4]), float(params[5])
    print(f"after 400 adam steps: ({tx:+.3f}, {ty:+.3f})  mse {float(val):.4f}")
    err = np.hypot(tx - true_flow[0], ty - true_flow[1])
    print(f"translation error: {err:.3f} px")
    assert err < 0.1, err


if __name__ == "__main__":
    main()
