"""Port parity under pipeline and sequence parallelism: ranks of a gloo
group (``parallel/launch.py``; one spawn of four ranks and one of two for
the file, each rank on one CPU thread) run the GPipe T5 encoder
(``parallel/pipeline.py``) and the sequence-parallel T5 encode and score
path (``parallel/sp.py``), held against the JAX package run here on the
conftest's virtual 8-device mesh as tests/test_pp_sp.py runs it (its
``pipeline_encode``, and ``encode`` / ``answer_log_probs`` under a ("dp",
"sp", "tp") mesh), on the same parameters and inputs.

World sizes stay at 4 or fewer, so the JAX test's (dp 2, sp 2, tp 2) mesh
is held by its two halves: (sp 2, tp 2) and (dp 2, sp 2), and sp 2 alone.

Tolerances, fp32, as the JAX tests': the pipeline 1e-5, SP 2e-5 (the CPU
BLAS sums a microbatch or a share of the rows in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from t2v_metrics_tpu.models import t5 as jt5  # noqa: E402
from t2v_metrics_tpu.parallel import mesh as jmesh  # noqa: E402
from t2v_metrics_tpu.parallel import pipeline as jpipe  # noqa: E402
from t2v_metrics_tpu_torch.models import t5 as tt5  # noqa: E402
from t2v_metrics_tpu_torch.parallel.launch import run_ranks  # noqa: E402

PP_TOL, SP_TOL = 1e-5, 2e-5


@pytest.fixture(scope="module")
def setup():
    """tests/test_pp_sp.py's T5 and inputs, and the port's config."""
    cfg = jt5.T5Config(vocab_size=128, d_model=32, d_kv=8, num_heads=4, d_ff=64,
                       enc_layers=4, dec_layers=2, num_buckets=8, max_distance=16)
    params = jt5.init_t5(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    b, s = 8, 24
    embeds = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    mask = rng.random((b, s)) > 0.1
    rng = np.random.default_rng(3)
    ans = rng.integers(2, 120, (b, 4)).astype(np.int32)
    amask = (rng.random((b, 4)) > 0.2).astype(np.float32)
    tcfg = tt5.T5Config(vocab_size=128, d_model=32, d_kv=8, num_heads=4, d_ff=64,
                        enc_layers=4, dec_layers=2, num_buckets=8, max_distance=16)
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, tcfg, tree, embeds, mask, ans, amask


def _case(name, kind, mesh, **args):
    return {"name": name, "kind": kind, "mesh": mesh, "args": args}


def _raw(devices, names):
    return ("raw", {"devices": devices, "names": names})


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    cfg, params, tcfg, tree, embeds, mask, ans, amask = setup
    common = dict(tree=tree, cfg=tcfg, embeds=embeds, mask=mask)
    pp2 = _raw(np.arange(4).reshape(2, 2), ("dp", "pp"))
    cases = [
        _case("pp4_micro4", "pipeline", _raw(np.arange(4), ("pp",)), n_micro=4, **common),
        _case("pp2_micro8", "pipeline", pp2, n_micro=8, **common),
        _case("pp3", "bad_split", _raw(np.arange(3), ("pp",)), n_micro=None, **common),
        _case("micro3", "bad_split", pp2, n_micro=3, **common),
        _case("sp2_tp2_encode", "sp_encode", ("mesh", {"dp": 1, "sp": 2, "tp": 2}), **common),
        _case("dp2_sp2_encode", "sp_encode", ("mesh", {"dp": 2, "sp": 2, "tp": 1}), **common),
        _case("sp2_tp2_score", "sp_score", ("mesh", {"dp": 1, "sp": 2, "tp": 2}),
              ans=ans, amask=amask, **common),
    ]
    init = f"file://{tmp_path_factory.mktemp('pp4') / 'init'}"
    return run_ranks(__import__("torch_parallel_workers").run_cases, 4, (cases,),
                     init_method=init, timeout_s=180)


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    cfg, params, tcfg, tree, embeds, mask, ans, amask = setup
    cases = [_case("sp2_encode", "sp_encode", ("mesh", {"dp": 1, "sp": 2, "tp": 1}),
                   tree=tree, cfg=tcfg, embeds=embeds, mask=mask)]
    init = f"file://{tmp_path_factory.mktemp('sp2') / 'init'}"
    return run_ranks(__import__("torch_parallel_workers").run_cases, 2, (cases,),
                     init_method=init, timeout_s=120)


def _jax_sp_mesh():
    return jmesh.make_mesh(dp=2, sp=2, tp=2)


@pytest.mark.parametrize("name,pp,n_micro", [("pp4_micro4", 4, 4), ("pp2_micro8", 2, 8)])
def test_pipeline_encode_matches_jax(setup, world4, name, pp, n_micro):
    cfg, params, _, _, embeds, mask, _, _ = setup
    mesh = Mesh(np.asarray(jax.devices()[:pp]), ("pp",))
    want = np.asarray(jax.jit(lambda p, e, m: jpipe.pipeline_encode(
        p, cfg, e, m, mesh, n_micro=n_micro))(params, jnp.asarray(embeds), jnp.asarray(mask)))
    for r, res in enumerate(world4):
        assert res[name]["layers"] == cfg.enc_layers // pp      # its stage only
        np.testing.assert_allclose(res[name]["out"], want, atol=PP_TOL, rtol=PP_TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("name,match", [("pp3", "enc_layers 4 not divisible by pp 3"),
                                        ("micro3", "batch 8 not divisible by n_micro 3")])
def test_pipeline_bad_splits_raise_on_every_rank(world4, name, match):
    """Every rank raised the ValueError before any collective (a rank left
    waiting would have failed the spawn by its time limit)."""
    assert [res[name] for res in world4] == [match] * 4


@pytest.fixture(scope="module")
def jax_encode(setup):
    cfg, params, _, _, embeds, mask, _, _ = setup
    mesh = _jax_sp_mesh()
    e = jax.device_put(jnp.asarray(embeds), NamedSharding(mesh, P("dp", "sp", None)))
    m = jax.device_put(jnp.asarray(mask), NamedSharding(mesh, P("dp", "sp")))
    with mesh:
        return np.asarray(jax.jit(lambda p, e, m: jt5.encode(p, cfg, e, m))(
            jmesh.shard_params(params, mesh), e, m))


@pytest.mark.parametrize("name", ["sp2_tp2_encode", "dp2_sp2_encode"])
def test_sp_encode_matches_jax(jax_encode, world4, name):
    want = jax_encode
    for r, res in enumerate(world4):
        np.testing.assert_allclose(res[name], want, atol=SP_TOL, rtol=1e-5,
                                   err_msg=f"rank {r}")


def test_sp2_encode_matches_jax(jax_encode, world2):
    want = jax_encode
    for r, res in enumerate(world2):
        np.testing.assert_allclose(res["sp2_encode"], want, atol=SP_TOL, rtol=1e-5,
                                   err_msg=f"rank {r}")


def test_sp_full_score_path_matches_jax(setup, world4):
    cfg, params, _, _, embeds, mask, ans, amask = setup
    mesh = _jax_sp_mesh()
    e = jax.device_put(jnp.asarray(embeds), NamedSharding(mesh, P("dp", "sp", None)))
    with mesh:
        want = np.asarray(jax.jit(lambda p, e: jt5.answer_log_probs(
            p, cfg, e, jnp.asarray(mask), jnp.asarray(ans), jnp.asarray(amask)))(
            jmesh.shard_params(params, mesh), e))
    for r, res in enumerate(world4):
        np.testing.assert_allclose(res["sp2_tp2_score"], want, atol=SP_TOL, rtol=1e-5,
                                   err_msg=f"rank {r}")
