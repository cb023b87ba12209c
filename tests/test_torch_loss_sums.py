"""The port's full-resolution loss sums (ecologysemanticsegmentation_torch/ops/loss_sums.py)
held against the JAX package's (ops/pallas/loss_sums.py).

On the CPU the port's wrappers run their plain versions, which compute what
the CUDA kernels compute: the forward against the Pallas kernel in interpret
mode and against the jnp reference, the plain analytic backward (dp and dg)
and the autograd Function against ``jax.grad``.  N = 3001 is not a multiple
of the Pallas kernel's 2048-lane tile, so its padding correction is in play;
labels carry ``-1`` ignores.  The kernels themselves are held against the
plain versions on the card (tests/test_torch_package.py's ``gpu`` tests, which
import no JAX so that they run there, and chip_smoke.py).

Tolerances, with reasons:

* sums: rtol 2e-5 / atol 1e-2 (f32 sums of 3001 terms of magnitude up to
  |log eps| = 16 in another order); the count row exactly;
* gradients against ``jax.grad`` of the jnp reference (the JAX package's CPU
  path): rtol 1e-5 / atol 1e-5, the same f32 formula;
* gradients against ``jax.grad`` of the Pallas custom VJP in interpret mode:
  rtol 2e-3 / atol 1e-3.  XLA's CPU code for that kernel rounds the
  near-singular terms 1/(p+eps) and 1/(1-p+eps) to about 1e-3 of their value
  where p is within 1e-4 of 0 or 1; float64 agrees with the port there (see
  ``test_bwd_port_is_the_f64_formula``).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecologysemanticsegmentation_tpu.ops.pallas import loss_sums as jls
from ecologysemanticsegmentation_torch.ops import loss_sums as tls
from _torch_parallel_ranks import bound_threads

bound_threads()

N = 3001
SUM_TOL = dict(rtol=2e-5, atol=1e-2)


def _case(rng, c, n=N):
    p = rng.rand(c, n).astype(np.float32)
    g = (rng.rand(c, n) > 0.5).astype(np.float32)
    g[rng.rand(c, n) < 0.1] = -1.0
    return p, g


@pytest.mark.parametrize("c", [1, 3, 11])
def test_forward_matches_pallas_interpret_and_reference(rng, c):
    p, g = _case(rng, c)
    got = tls.fused_loss_sums(torch.from_numpy(p), torch.from_numpy(g)).numpy()
    kernel = jls.fused_loss_sums(jnp.asarray(p), jnp.asarray(g), interpret=True)
    ref = jls._sums_reference(jnp.asarray(p), jnp.asarray(g))
    np.testing.assert_allclose(got, np.asarray(kernel), **SUM_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **SUM_TOL)
    np.testing.assert_array_equal(got[7], (g >= 0).sum(1))


def _jax_grads(fn, p, g, cot):
    def scal(a, b):
        return jnp.sum(jnp.asarray(cot) * fn(a, b))

    dp, dg = jax.grad(scal, argnums=(0, 1))(jnp.asarray(p), jnp.asarray(g))
    return np.asarray(dp), np.asarray(dg)


@pytest.mark.parametrize("c", [1, 3, 11])
def test_backward_matches_jax_grad(rng, c):
    p, g = _case(rng, c)
    cot = rng.randn(8, c).astype(np.float32)
    ref_dp, ref_dg = _jax_grads(jls._sums_reference, p, g, cot)
    pal_dp, pal_dg = _jax_grads(lambda a, b: jls.fused_loss_sums(a, b, interpret=True),
                                p, g, cot)

    dp, dg = tls.loss_sums_bwd_reference(torch.from_numpy(p), torch.from_numpy(g),
                                         torch.from_numpy(cot))
    np.testing.assert_allclose(dp.numpy(), ref_dp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dg.numpy(), ref_dg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dp.numpy(), pal_dp, rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(dg.numpy(), pal_dg, rtol=2e-3, atol=1e-3)

    # The autograd Function routes CPU tensors to the plain backward, both inputs.
    tp = torch.from_numpy(p).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    (torch.from_numpy(cot) * tls.fused_loss_sums(tp, tg)).sum().backward()
    np.testing.assert_array_equal(tp.grad.numpy(), dp.numpy())
    np.testing.assert_array_equal(tg.grad.numpy(), dg.numpy())


def test_bwd_port_is_the_f64_formula(rng):
    """Where the port and the Pallas interpret run differ most (p near 1),
    the port is the float64 value of the formula to f32 rounding."""
    p, g = _case(rng, 3)
    cot = rng.randn(8, 3).astype(np.float32)
    dp = tls.loss_sums_bwd_reference(torch.from_numpy(p), torch.from_numpy(g),
                                     torch.from_numpy(cot))[0].numpy()
    pal_dp = _jax_grads(lambda a, b: jls.fused_loss_sums(a, b, interpret=True), p, g, cot)[0]
    i = np.unravel_index(np.abs(dp - pal_dp).argmax(), dp.shape)
    P, G, eps = p.astype(np.float64)[i], max(g[i], 0.0), 1e-7
    k = cot.astype(np.float64)[:, i[0]]
    omp = 1.0 - P
    want = (k[1] + k[2] * 2 * P + k[3] * G
            + k[4] * (omp * np.sqrt(omp) / (P + eps) - 1.5 * np.sqrt(omp) * np.log(P + eps))
            + k[5] * (1.5 * np.sqrt(P) * np.log(omp + eps) - P * np.sqrt(P) / (omp + eps))
            + k[6] * (float(P > 0) - np.sign(P) / (1 + np.exp(abs(P))))) * float(g[i] >= 0)
    np.testing.assert_allclose(dp[i], want, rtol=1e-5)
    assert abs(pal_dp[i] - want) > 10 * abs(dp[i] - want)


@pytest.mark.parametrize("c", [1, 3])
def test_nhwc_matches_jax_including_channel_slice(rng, c):
    probs = rng.rand(2, 13, 17, 4).astype(np.float32)
    labels = (rng.rand(2, 13, 17, 4) > 0.5).astype(np.float32)
    labels[rng.rand(*labels.shape) < 0.1] = -1.0
    sl = slice(1, 1 + c)
    # a channel slice of a wider NHWC tensor: not contiguous for c < 4
    tp, tg = torch.from_numpy(probs)[..., sl], torch.from_numpy(labels)[..., sl]
    assert not tp.is_contiguous()
    got = tls.loss_sums_nhwc(tp, tg).numpy()
    want = jls.loss_sums_nhwc(jnp.asarray(probs)[..., sl], jnp.asarray(labels)[..., sl],
                              use_pallas=True, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **SUM_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jls._sums_reference(jnp.asarray(probs[..., sl].reshape(-1, c).T),
                                            jnp.asarray(labels[..., sl].reshape(-1, c).T))),
        **SUM_TOL)


def test_swapped_single_organ_with_ignores_is_nan_in_both(rng):
    """C = 1 losses put the labels in the prediction slot (losses.py
    single-organ swap), so a -1 label enters row 4 as log(-1 + eps) and row 5
    as (-1) * sqrt(-1): NaN in the JAX package, and so in the port.  The
    other rows stay finite and agree."""
    probs = rng.rand(1, 64).astype(np.float32)
    labels = (rng.rand(1, 64) > 0.5).astype(np.float32)
    labels[0, ::7] = -1.0
    got = tls.fused_loss_sums(torch.from_numpy(labels), torch.from_numpy(probs)).numpy()
    want = np.asarray(jls._sums_reference(jnp.asarray(labels), jnp.asarray(probs)))
    assert np.isnan(want[4:6]).all() and np.isnan(got[4:6]).all()
    rows = [0, 1, 2, 3, 6, 7]
    np.testing.assert_allclose(got[rows], want[rows], **SUM_TOL)


@pytest.mark.parametrize("bad,err", [
    (lambda p, g: (p.double(), g), TypeError),                        # not f32
    (lambda p, g: (p, g.to(torch.bfloat16)), TypeError),              # labels not f32
    (lambda p, g: (p, g[:, :-1]), ValueError),                        # shape mismatch
    (lambda p, g: (p[:, :0], g[:, :0]), ValueError),                  # no pixels
    (lambda p, g: (torch.zeros(17, 8), torch.zeros(17, 8)), ValueError),  # C > 16
    (lambda p, g: (p.to("meta"), g.to("meta")), RuntimeError),        # no implementation
])
def test_wrapper_rejects(bad, err):
    p, g = torch.rand(3, 32), torch.ones(3, 32)
    with pytest.raises(err):
        tls.fused_loss_sums(*bad(p, g))
    with pytest.raises(err):
        a, b = bad(p, g)
        tls.loss_sums_nhwc(a.T, b.T)


def test_wrapper_path_choice():
    """The kernels read contiguous inputs that start on a 16-byte boundary
    as one flat stream of float4, and anything else through the pixel
    stride; the wrapper decides from the strides and the pointers."""
    def path(p, g):
        (p, sp), (g, sg) = tls._rows(p), tls._rows(g)
        return tls._vector_path(p, g, sp, sg)

    wide = torch.rand(64, 4)
    flat = torch.rand(64 * 3 + 4)
    for c in (1, 3, 11):
        x = torch.rand(50, c)
        assert path(x, torch.ones(50, c))                          # contiguous
        assert path(torch.rand(c, 50).T, x)                        # copied to pixel-major
        odd = torch.rand(50 * c + 1)[1:].view(50, c)               # 4 bytes off 16
        assert not path(odd, x) and not path(x, odd)
    assert path(flat[4:4 + 64 * 3].view(64, 3), torch.ones(64, 3))  # 16 bytes in: aligned
    assert not path(wide[:, 1:2], torch.ones(64, 1))               # channel slice, stride 4
    assert not path(wide[:, :3], torch.ones(64, 3))                # pixel stride 4, not 3
