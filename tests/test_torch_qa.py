"""The port's paper QA experiment (§5) and §6 second-order unit against
the JAX package on the CPU, at a smoke size (k = 12, embeddings 16,
documents of 6 facts = 24 tokens), from JAX's parameters carried over by
``convert.qa_params_from_jax``.

Tolerances: the loss within 1e-5 relative and every parameter gradient
leaf within max|Δ| ≤ 1e-5 · max|g_JAX| (fp32 sums in another order
through 24 GRU steps and the answer head); the second-order scan's
outputs within 1e-5 and its parameter gradients as the model's; three
``train_qa`` steps' validation losses within 1e-4 relative (the Adam
updates compound those differences). The second-order scan's input
cotangents are not compared: at t = 0 the probe is exactly zero and
JAX's gradient of x / (‖x‖ + 1e-6) there is NaN, torch's finite; no
parameter sees it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_qa import QAConfig as JaxQAConfig
from repro.core.second_order import second_order_params as jso_params
from repro.core.second_order import second_order_scan as jso_scan
from repro.data.cloze import ClozeTask as JaxClozeTask
from repro.qa.model import QAModel as JaxQAModel
from repro.qa.train import train_qa as jax_train_qa
from repro_torch import convert
from repro_torch.configs.paper_qa import QAConfig
from repro_torch.core.second_order import second_order_scan
from repro_torch.data import ClozeTask
from repro_torch.qa import ATTENTION_VARIANTS, QAModel, train_qa
from repro_torch.qa.train import put_batch
from repro_torch.tree import leaves

SMALL = dict(embed_dim=16, hidden=12, batch_size=4)
N_FACTS = 6
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), tree)


def _jax_model(att):
    return JaxQAModel(JaxQAConfig(attention=att, **SMALL))


def _port(att, jax_params):
    cfg = QAConfig(attention=att, **SMALL)
    return QAModel(cfg), convert.qa_params_from_jax(_np(jax_params), cfg,
                                                    device=CPU)


def _grad_close(t_tree, j_tree, tol):
    t_leaves, j_leaves = leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        j = np.asarray(j)
        assert t.shape == j.shape and np.isfinite(j).all()
        err = np.abs(t.numpy() - j).max()
        assert err <= tol * np.abs(j).max(), err


@pytest.mark.parametrize("att", ATTENTION_VARIANTS)
def test_loss_and_every_parameter_gradient_match_jax(att):
    jmodel = _jax_model(att)
    jp = jmodel.init(jax.random.PRNGKey(3))
    batch = JaxClozeTask(n_facts=N_FACTS, seed=5).batch(4, step=2)
    (jloss, jacc), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_and_acc(p, batch), has_aux=True)(jp)

    model, params = _port(att, jp)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, acc = model.loss_and_acc(params, put_batch(
        ClozeTask(n_facts=N_FACTS, seed=5).batch(4, step=2), CPU))
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert acc.item() == float(jacc)
    _grad_close(list(grads), jgrads, 1e-5)


@pytest.mark.parametrize("att", ["linear", "gated_linear", "second_order",
                                 "softmax"])
def test_document_representation_size(att):
    """The linear variants and the §6 unit keep k×k whatever n; softmax
    keeps n×k (the paper's Table-1 memory row)."""
    model, params = _port(att, _jax_model(att).init(jax.random.PRNGKey(0)))
    k = SMALL["hidden"]
    for n in (8, 64):
        doc = torch.randint(0, 93, (2, n),
                            generator=torch.Generator().manual_seed(n))
        with torch.no_grad():
            rep, _ = model.encode_doc(params, doc)
        assert rep.shape == ((2, n, k) if att == "softmax" else (2, k, k))


def test_second_order_scan_matches_jax():
    jp = jso_params(jax.random.PRNGKey(1), 8, 12)
    xs = np.random.default_rng(0).standard_normal((3, 20, 8)).astype(
        np.float32)

    def jloss(p):
        hs, h, c = jso_scan(p, jnp.asarray(xs))
        return (hs ** 2).sum() + (h ** 3).sum() + (c ** 2).sum()

    jout = jso_scan(jp, jnp.asarray(xs))
    jgrads = jax.grad(jloss)(jp)

    params = _torch(jp)
    assert params["alpha_logit"].shape == ()
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    out = second_order_scan(params, torch.from_numpy(xs))
    for t, j in zip(out, jout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-5)
    hs, h, c = out
    grads = torch.autograd.grad(
        (hs ** 2).sum() + (h ** 3).sum() + (c ** 2).sum(), flat)
    _grad_close(list(grads), jgrads, 1e-5)


def test_second_order_c_accumulates_outer_products():
    """With α → 1 the C state is Σ h hᵀ of the produced states."""
    params = _torch(jso_params(jax.random.PRNGKey(0), 4, 6))
    params["alpha_logit"] = torch.tensor(100.0)
    xs = torch.randn((2, 10, 4), generator=torch.Generator().manual_seed(2))
    hs, _, c = second_order_scan(params, xs)
    torch.testing.assert_close(c, torch.einsum("btk,btl->bkl", hs, hs),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("att", ATTENTION_VARIANTS)
def test_three_train_qa_steps_match_jax_validation_losses(att):
    jcfg = JaxQAConfig(attention=att, **SMALL)
    want = jax_train_qa(att, steps=3, eval_every=1, cfg=jcfg,
                        task=JaxClozeTask(n_facts=N_FACTS, seed=1))
    jp = JaxQAModel(jcfg).init(jax.random.PRNGKey(0))
    cfg = QAConfig(attention=att, **SMALL)
    got = train_qa(att, steps=3, eval_every=1, cfg=cfg,
                   task=ClozeTask(n_facts=N_FACTS, seed=1), device="cpu",
                   params=convert.qa_params_from_jax(_np(jp), cfg))
    assert got.steps == want.steps == [1, 2, 3]
    np.testing.assert_allclose(got.val_loss, want.val_loss, rtol=1e-4)
    assert np.isfinite(got.val_loss).all()
    assert got.best_acc == max(got.val_acc)


def test_train_qa_from_its_own_seed_runs_on_the_cpu():
    res = train_qa("gated_linear", steps=2, eval_every=1, device="cpu",
                   cfg=QAConfig(**SMALL), task=ClozeTask(n_facts=N_FACTS))
    assert res.attention == "gated_linear" and res.steps == [1, 2]
    assert np.isfinite(res.val_loss).all()
    assert res.steps_to_acc(2.0) == -1


def test_qa_params_of_another_variant_refused():
    jp = _np(_jax_model("linear").init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="gated_linear"):
        convert.qa_params_from_jax(
            jp, QAConfig(attention="gated_linear", **SMALL))


def test_train_qa_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_qa("linear", steps=1)

