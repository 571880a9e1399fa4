"""The port's learned mask-MVDR front end and joint config-5 training
(`dsr_tpu_torch.models.{neural_beamformer,joint}`) against the JAX
package's on the CPU.  The data are 3 reverberant 6-mic utterances made by
`tools/exp_joint_ctc.build_data` (the config-5 scene) through the JAX
analysis at M = 64 m = 2 r = 2; flax's parameters are carried across by
`convert.joint` with relative-position tables, LayerNorm scales and biases
drawn at random.  vocab 10, dim 32, 2 layers, 2 heads, mask hidden 32.

Tolerances:
- masks, Φs, Φn, logits: 1e-4 of the largest magnitude (float32);
- MVDR weights and enhanced subbands, float32: per bin max(1e-4, 3e-7·κ)
  of the bin's largest magnitude, κ the condition number of the bin's
  loaded Φn: float32 rounding of Φ (~1e-7) is amplified by up to κ, which
  reaches ~2e4 in the lowest bins of this reverberant scene (the JAX
  package's own float32 weights are 6e-5 from float64 there);
- the same in float64 (both packages under x64): 1e-9;
- CTC loss 1e-5 relative; gradients 1e-3 of each leaf's largest magnitude,
  1e-6 absolute for the k bias (`_torch_parity.grads_match`); the mask
  estimator's, through the solve, max(1e-3, 3e-7·κ); in float64 1e-9;
- the optimiser, given the JAX gradients: 1e-6 absolute after two steps
  (Adam at lr 3e-3; float32 rounding of the moments only).  Trained
  parameters are not compared after real steps: the k bias's gradient is
  rounding noise whose sign Adam turns into a step of ±lr;
- the loss after two real steps: 1e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import grads_match, randomized, rel
from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.models import joint as jj
from dsr_tpu.models import neural_beamformer as jnb
from dsr_tpu.models.conformer import ctc_loss as jctc_loss
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu_torch import convert
from dsr_tpu_torch.models import conformer as pc
from dsr_tpu_torch.models import joint as pj
from dsr_tpu_torch.models import neural_beamformer as pnb
from tools.exp_joint_ctc import build_data

M, VOCAB = 64, 10
SIZE = dict(dim=32, layers=2, heads=2)
LR = 3e-3


@pytest.fixture(scope="module")
def system():
    X, labels, label_lens, *_ = build_data(jnp, jfb, JFilterbankConfig(M=M, m=2, r=2), 3, seed=0)
    X = np.array(X)
    jm = jj.JointBeamformerCtc(vocab=VOCAB, subbands_m=M, hidden=32, **SIZE)
    params = randomized(jm.init(jax.random.PRNGKey(0), X[:1]), 4)
    T = X.shape[2]
    frame_lens = np.array([T, T - 40, T - 90], np.int32)
    return jm, params, (X, labels, label_lens, frame_lens)


def _port(params):
    pm = pj.JointBeamformerCtc(VOCAB, M, hidden=32, device="cpu", **SIZE)
    pm.load_state_dict(convert.joint(params), strict=True)
    return pm


def _f64(tree):
    """Call inside `jax.enable_x64`: every leaf as float64."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _jax_loss(jm, data, dtype=jnp.complex64):
    X, labels, label_lens, frame_lens = data

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(X, dtype))
        llen = jnp.minimum((jnp.asarray(frame_lens) + 3) // 4, logits.shape[1])
        return jctc_loss(logits, llen, jnp.asarray(labels), jnp.asarray(label_lens))

    return jax.jit(jax.value_and_grad(loss_fn))


def _port_loss(pm, data, dtype=torch.complex64):
    X, labels, label_lens, frame_lens = data
    logits = pm(torch.as_tensor(X).to(dtype))
    llen = torch.clamp_max((torch.as_tensor(frame_lens) + 3) // 4, logits.shape[1])
    return pc.ctc_loss(logits, llen, labels, label_lens)


def test_neural_beamformer_matches_jax(system):
    """Masks, masked PSDs, MVDR weights and the enhanced subbands of one
    utterance (6 ch x 96 frames x 33 bins), in float32 and in float64, and
    of the batch in float64."""
    _, params, (X, *_) = system
    fp = params["params"]["frontend"]
    x = X[0, :, :96]

    def jax_chain(fp_, x_):
        logmag = jnp.log(jnp.mean(jnp.abs(x_), axis=0) + 1e-6)
        ms, mn = jnb.MaskEstimator(32).apply({"params": fp_["MaskEstimator_0"]}, logmag)
        phi_s, phi_n = jnb.masked_psd(x_, ms), jnb.masked_psd(x_, mn)
        y = jnb.NeuralBeamformer(32).apply({"params": fp_}, x_)
        return ms, mn, phi_s, phi_n, jnb.mvdr_from_psds(phi_s, phi_n), y

    @torch.no_grad()
    def port_chain(nb_, x_):
        ms, mn = nb_.mask(torch.log(x_.abs().mean(0) + 1e-6))
        phi_s, phi_n = pnb.masked_psd(x_, ms), pnb.masked_psd(x_, mn)
        return ms, mn, phi_s, phi_n, pnb.mvdr_from_psds(phi_s, phi_n), nb_(x_)

    nb = pnb.NeuralBeamformer(M // 2 + 1, 32, device="cpu")
    nb.load_state_dict(convert.neural_beamformer(fp), strict=True)
    ref = [np.asarray(a) for a in jax_chain(fp, x)]
    got = [a.numpy() for a in port_chain(nb, torch.as_tensor(x))]
    for g, r in zip(got[:4], ref[:4]):
        assert rel(g, r) <= 1e-4
    # float32 rounding of Φ (~1e-7) moves the weights by up to κ·1e-7: the
    # lowest bins of this reverberant scene have κ of 1e3 to 2e4
    kappa = pnb.loaded_condition(torch.tensor(ref[3])).numpy()
    for g, r, t_axis in ((got[4], ref[4], 1), (got[5], ref[5], 0)):
        err = np.abs(g - r).max(axis=t_axis) / np.abs(r).max(axis=t_axis)
        assert np.all(err <= np.maximum(1e-4, 3e-7 * kappa)), (err, kappa)

    with jax.enable_x64(True):
        fp64 = _f64(fp)
        ref64 = [np.asarray(a) for a in jax_chain(fp64, jnp.asarray(x, jnp.complex128))]
        yb64 = np.asarray(jax.vmap(lambda u: jnb.NeuralBeamformer(32).apply({"params": fp64},
                                                                             u))(
            jnp.asarray(X, jnp.complex128)))
    nb64 = nb.double()
    got64 = port_chain(nb64, torch.as_tensor(x).to(torch.complex128))
    for g, r in zip(got64, ref64):
        assert g.dtype in (torch.float64, torch.complex128) and rel(g.numpy(), r) <= 1e-9
    with torch.no_grad():
        assert rel(nb64(torch.as_tensor(X).to(torch.complex128)).numpy(), yb64) <= 1e-9


def test_joint_loss_and_gradients_match_jax(system):
    """The CTC loss over ragged frame counts and the gradients of both
    subtrees (the mask estimator's through the MVDR solve), in float64
    (the same arithmetic, 1e-9) and in float32 (the AM's 1e-3; the
    frontend's through the solve, whose κ reaches ~2e4 in the lowest bins
    here, max(1e-3, 3e-7·κ))."""
    jm, params, data = system
    loss_j, grads_j = _jax_loss(jm, data)(params)
    pm = _port(params)
    loss = _port_loss(pm, data)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))

    with jax.enable_x64(True):
        loss64_j, grads64_j = _jax_loss(jm, data, jnp.complex128)(_f64(params))
    pm64 = _port(params).double()
    loss64 = _port_loss(pm64, data, torch.complex128)
    loss64.backward()
    assert abs(loss64.item() - float(loss64_j)) <= 1e-12 * abs(float(loss64_j))
    grads_match(pm64, convert.joint(grads64_j), tol=1e-9, floor=1e-12)

    with torch.no_grad():
        X64 = torch.as_tensor(data[0]).to(torch.complex128)
        _, mn = pm64.frontend.mask(torch.log(X64.abs().mean(-3) + 1e-6))
        kappa = float(pnb.loaded_condition(pnb.masked_psd(X64, mn)).max())
    ref = convert.joint(grads_j)
    sub = lambda prefix: {k[len(prefix):]: v for k, v in ref.items()  # noqa: E731
                          if k.startswith(prefix)}
    grads_match(pm.am, sub("am."))
    grads_match(pm.frontend, sub("frontend."), tol=max(1e-3, 3e-7 * kappa))


def test_update_matches_optax_on_the_jax_gradients(system):
    """`apply_gradients` (make_train_step's update) given the JAX gradients
    as `.grad`, two steps, against optax.adam and chain(clip_by_global_norm,
    adam), plain, with the frontend frozen, and clipped at 1.0."""
    jm, params0, data = system
    grad_fn = _jax_loss(jm, data)
    frozen_grads = lambda g: jax.tree_util.tree_map_with_path(  # noqa: E731
        lambda path, a: (jnp.zeros_like(a) if any(getattr(k, "key", None) == "frontend"
                                                  for k in path) else a), g)
    for frozen, clip in ((False, None), (True, None), (False, 1.0)):
        tx = optax.adam(LR) if clip is None else optax.chain(optax.clip_by_global_norm(clip),
                                                             optax.adam(LR))
        p, opt = params0, tx.init(params0)
        pm = _port(params0)
        optimizer = torch.optim.Adam(pm.parameters(), lr=LR)
        for _ in range(2):
            _, g = grad_fn(p)
            sd = convert.joint(g)
            for name, prm in pm.named_parameters():
                prm.grad = sd[name].clone()
            pj.apply_gradients(pm, optimizer, frozen_frontend=frozen, clip_norm=clip)
            updates, opt = tx.update(frozen_grads(g) if frozen else g, opt, p)
            p = optax.apply_updates(p, updates)
        ref = convert.joint(p)
        for name, prm in pm.named_parameters():
            err = float((prm.detach() - ref[name]).abs().max())
            assert err <= 1e-6, (frozen, clip, name, err)
        if frozen:
            start = convert.joint(params0)
            assert all(torch.equal(prm.detach(), start["frontend." + n])
                       for n, prm in pm.frontend.named_parameters())


def test_two_train_steps_match_jax(system):
    """`make_train_step` against the JAX `make_train_step` (Adam 3e-3, frame
    counts given): the losses of both steps and the loss after them."""
    jm, params, data = system
    X, labels, label_lens, frame_lens = data
    tx = optax.adam(LR)
    jstep = jj.make_train_step(jm, tx)
    p, opt = params, tx.init(params)
    pm = _port(params)
    step = pj.make_train_step(pm, torch.optim.Adam(pm.parameters(), lr=LR))
    args = (jnp.asarray(labels), jnp.asarray(label_lens), jnp.asarray(frame_lens))
    for _ in range(2):
        p, opt, loss_j = jstep(p, opt, jnp.asarray(X), *args)
        loss = step(torch.as_tensor(X), labels, label_lens, frame_lens)
        assert abs(float(loss) - float(loss_j)) <= 1e-3 * abs(float(loss_j))
    after_j = float(_jax_loss(jm, data)(p)[0])
    with torch.no_grad():
        after = float(_port_loss(pm, data))
    assert abs(after - after_j) <= 1e-3 * abs(after_j)


def test_oracle_mvdr_ctc_logits_match_jax(system):
    """`OracleMvdrCtc` with fixed weights (random unit-norm columns)."""
    _, _, (X, *_) = system
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((M // 2 + 1, 6)) + 1j * rng.standard_normal((M // 2 + 1, 6)))
    w = (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.complex64)
    jm = jj.OracleMvdrCtc(vocab=VOCAB, subbands_m=M, **SIZE)
    params = randomized(jm.init(jax.random.PRNGKey(1), X[:1], w), 6)
    ref = np.asarray(jm.apply(params, X, w))
    pm = pj.OracleMvdrCtc(VOCAB, M, device="cpu", **SIZE)
    pm.load_state_dict(convert.joint(params), strict=True)
    with torch.no_grad():
        out = pm(torch.as_tensor(X), torch.as_tensor(w)).numpy()
    assert rel(out, ref) <= 1e-4
