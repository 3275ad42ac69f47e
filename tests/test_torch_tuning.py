"""The port's runtime autotuner against the reference's.

Twins of ``test_tuning.py``.  The tuner's shadow runs are the sim
runtime's, whose ledger does not depend on the framework, so for the
same machine the port must pick the same ``(tile, n_streams, policy,
work_centric)`` with the same virtual-clock makespans as the reference,
report the same counters, fingerprint the topology the same way and
key its cache the same way but for the backend's name.  Where a tuned
call computes, the port (``cuda`` backend on the CPU: the GEMM kernel's
plain version) is held to the reference's oracle tolerances.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.api import BlasxContext as RefContext
from repro.core.runtime import RuntimeConfig as RefConfig
from repro.tuning import Autotuner as RefAutotuner
from repro.tuning import TuningCache as RefCache
from repro.tuning import reset_shared_cache as ref_reset_shared_cache
from repro.tuning import training_rows as ref_training_rows
from repro_torch.api import (BlasxContext, CblasNoTrans, CblasRowMajor,
                             cblas_dgemm)
from repro_torch.core import blas3
from repro_torch.core.runtime import RuntimeConfig
from repro_torch.tuning import (ENV_CACHE_PATH, Autotuner, CostModel,
                                TuningCache, cache_key, reset_shared_cache,
                                shape_bucket, shared_cache,
                                topology_fingerprint, training_rows)

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

ROUTINES = ("gemm", "syrk", "syr2k", "symm", "trmm", "trsm")
TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(autouse=True)
def _fresh_shared_caches():
    """Isolate both packages' process-wide default caches."""
    reset_shared_cache()
    ref_reset_shared_cache()
    yield
    reset_shared_cache()
    ref_reset_shared_cache()


def _kw(**kw):
    kw.setdefault("n_devices", 2)
    kw.setdefault("mode", "sim")
    kw.setdefault("cache_bytes", 256 << 20)
    return kw


def _cfg(**kw):
    return RuntimeConfig(device="cpu", **_kw(**kw))


def _shadow_kw(**kw):
    kw.setdefault("execute", False)
    kw.setdefault("record_trace", False)
    return _kw(**kw)


def _tuners(cache=None, ref_cache=None, **kw):
    """The reference's tuner (numpy backend) and the port's (cuda
    backend, on the host) over the same modeled machine."""
    cfg_kw = kw.pop("cfg", {})
    ref = RefAutotuner(RefConfig(**_shadow_kw(**cfg_kw)),
                       cache=RefCache("") if ref_cache is None else ref_cache,
                       **kw)
    port = Autotuner(RuntimeConfig(device="cpu", **_shadow_kw(**cfg_kw)),
                     cache=TuningCache("") if cache is None else cache, **kw)
    return ref, port


def _pick(best):
    return (best.tile, best.n_streams, best.policy, best.work_centric,
            best.makespan, best.default_makespan, best.source)


def _same_key(ref_key, key):
    """Cache keys differ only in the backend's name."""
    assert key.split("/")[1] == "cuda" and ref_key.split("/")[1] == "numpy"
    assert key.replace("/cuda/", "/numpy/") == ref_key


COUNTERS = ("sweeps", "bucket_sweeps", "confirmations", "cache_hits",
            "file_cache_hits", "process_cache_hits", "model_adoptions",
            "model_fallbacks", "cache_entries")


def _same_report(ref_rep, rep):
    for name in COUNTERS:
        assert rep[name] == ref_rep[name], name
    assert [e["source"] for e in rep["entries"]] == \
        [e["source"] for e in ref_rep["entries"]]
    for e, r in zip(rep["entries"], ref_rep["entries"]):
        for f in ("tile", "n_streams", "policy", "work_centric",
                  "makespan", "default_makespan"):
            assert e.get(f) == r.get(f), f


# -------------------------------------------------------------- the search
@pytest.mark.parametrize("routine", ROUTINES)
def test_tuned_makespan_never_worse_than_default(routine):
    """Tuned <= default in both precisions (the default is candidate
    zero), with the reference's pick and makespans."""
    ref, port = _tuners(cfg=dict(n_devices=3), tiles=(128, 256, 512),
                        streams=(2, 4), policies=("blasx", "static"))
    for dtype in ("float64", "float32"):
        want = ref.tune(routine, 1024, 1024, 1024, dtype=dtype)
        best = port.tune(routine, 1024, 1024, 1024, dtype=dtype)
        assert best.makespan <= best.default_makespan * (1 + 1e-12)
        assert best.source == "swept"
        assert _pick(best) == _pick(want)
        _same_key(want.key, best.key)
    assert port.sweeps == ref.sweeps


def test_tuned_pick_is_deterministic_and_equals_the_reference():
    picks = []
    for _ in range(2):
        tuner = Autotuner(RuntimeConfig(device="cpu", **_shadow_kw(
            n_devices=3, seed=7)), cache=TuningCache())
        picks.append(_pick(tuner.tune("gemm", 2048, 2048, 2048,
                                      dtype="float64")))
    ref = RefAutotuner(RefConfig(**_shadow_kw(n_devices=3, seed=7)),
                       cache=RefCache())
    assert picks[0] == picks[1] == _pick(
        ref.tune("gemm", 2048, 2048, 2048, dtype="float64"))


def test_shape_bucket_reuse():
    from repro.tuning import shape_bucket as ref_shape_bucket
    for shape in [(1, 1, 1), (1000, 1000, 1000), (4100, 33, 90),
                  (181, 182, 183), (64, 65, 8192)]:
        assert shape_bucket(*shape) == ref_shape_bucket(*shape)
    assert shape_bucket(1000, 1000, 1000) == (1024, 1024, 1024)
    ref, port = _tuners(tiles=(128, 256), streams=(2,), policies=("blasx",))
    for t in (ref, port):
        first = t.tune("gemm", 1000, 900, 1020)
        swept = t.sweeps
        assert swept > 0
        again = t.tune("gemm", 1024, 1024, 1024)
        assert t.sweeps == swept and again.source == "cache"
        assert (again.tile, again.n_streams) == (first.tile, first.n_streams)
    _same_report(ref.report(), port.report())


def test_fingerprint_equals_the_reference_and_separates_topologies():
    for kw in (dict(n_devices=2), dict(n_devices=3),
               dict(n_devices=2, h2d_bw=1e12), dict(cache_bytes=1 << 20)):
        assert topology_fingerprint(RuntimeConfig(device="cpu",
                                                  **_shadow_kw(**kw))) == \
            RefAutotuner(RefConfig(**_shadow_kw(**kw)),
                         cache=RefCache("")).fingerprint
    base = _cfg()
    assert topology_fingerprint(base) == topology_fingerprint(
        _cfg(n_streams=8, policy="static"))
    assert topology_fingerprint(base) == topology_fingerprint(
        dataclasses.replace(base, device="cuda", backend="torch"))
    assert topology_fingerprint(base) != topology_fingerprint(
        _cfg(n_devices=3))
    assert cache_key("f", "cuda", "gemm", (64, 64, 64), "bfloat16") == \
        "f/cuda/gemm/64x64x64/bfloat16"


def test_cache_file_roundtrip(tmp_path):
    path = str(tmp_path / "tuning.json")
    kw = dict(tiles=(128, 256), streams=(2,), policies=("blasx",))
    t1 = Autotuner(_cfg(execute=False), cache=path, **kw)
    best = t1.tune("syrk", 512, 512, 512)
    assert t1.sweeps > 0
    t2 = Autotuner(_cfg(execute=False), cache=TuningCache(path), **kw)
    again = t2.tune("syrk", 512, 512, 512)
    assert t2.sweeps == 0 and again.source == "cache-file"
    assert t2.file_cache_hits == 1 and t2.process_cache_hits == 0
    assert (again.tile, again.makespan) == (best.tile, best.makespan)
    with open(path) as f:
        keys = list(json.load(f)["entries"])
    assert len(keys) == 1 and "/cuda/syrk/512x512x512/float64" in keys[0]


@pytest.mark.parametrize("text", ['{"schema": 999, "entries": {"x": {}}}',
                                  '{"schema": 1, "entries": {"x"',
                                  '{"schema": 1, "entries": []}', "[]"])
def test_unknown_or_corrupt_cache_file_degrades_to_resweep(tmp_path, text):
    """A file of another schema, a truncated one or a wrongly shaped
    one loads nothing and never crashes; the next sweep overwrites it."""
    path = tmp_path / "bad.json"
    path.write_text(text)
    assert len(TuningCache(str(path))) == 0
    tuner = Autotuner(_cfg(execute=False), cache=str(path), tiles=(128,),
                      streams=(2,), policies=("blasx",))
    best = tuner.tune("gemm", 256, 256, 256)
    assert tuner.sweeps > 0 and best.source == "swept"
    assert len(TuningCache(str(path))) == 1


def test_entry_from_different_candidate_space_is_not_reused(tmp_path):
    path = str(tmp_path / "t.json")
    Autotuner(_cfg(execute=False), cache=path, tiles=(128,), streams=(2,),
              policies=("blasx",), default_tile=128).tune("gemm", 512, 512,
                                                          512)
    wide_kw = dict(tiles=(128, 256), streams=(2, 4), policies=("blasx",),
                   default_tile=256)
    wide = Autotuner(_cfg(execute=False), cache=TuningCache(path), **wide_kw)
    best = wide.tune("gemm", 512, 512, 512)
    assert wide.sweeps > 0 and best.source == "swept"
    assert best.makespan <= best.default_makespan * (1 + 1e-12)
    wide2 = Autotuner(_cfg(execute=False), cache=TuningCache(path),
                      **wide_kw)
    assert wide2.tune("gemm", 512, 512, 512).source == "cache-file"
    assert wide2.sweeps == 0


def test_the_port_keeps_its_own_cache_variable_and_shared_cache(
        tmp_path, monkeypatch):
    """``BLASX_TORCH_TUNING_CACHE`` backs the port's cache; the
    reference's ``BLASX_TUNING_CACHE`` does not, so neither package
    reads the other's verdicts; and the two shared caches differ."""
    path = str(tmp_path / "port.json")
    assert ENV_CACHE_PATH == "BLASX_TORCH_TUNING_CACHE"
    monkeypatch.delenv(ENV_CACHE_PATH, raising=False)
    monkeypatch.setenv("BLASX_TUNING_CACHE", path)
    assert TuningCache().path is None
    assert RefCache().path == path
    monkeypatch.setenv(ENV_CACHE_PATH, path)
    assert TuningCache().path == path
    assert TuningCache("").path is None         # explicit memory-only
    monkeypatch.delenv("BLASX_TUNING_CACHE")
    monkeypatch.delenv(ENV_CACHE_PATH)
    from repro.tuning import shared_cache as ref_shared_cache
    assert shared_cache() is shared_cache()
    assert shared_cache() is not ref_shared_cache()


# ------------------------------------------------------------ context layer
def test_second_context_same_topology_is_pure_cache_hit():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((260, 260))
    B = rng.standard_normal((260, 260))
    reps = []
    for Ctx, cfg in ((RefContext, RefConfig(**_kw())),
                     (BlasxContext, _cfg())):
        with Ctx(cfg, auto_tune=True) as c1:
            np.testing.assert_allclose(c1.gemm(A, B, tile="auto").array(),
                                       A @ B, **TOL)
            rep1 = c1.tuning_report()
        with Ctx(cfg, auto_tune=True) as c2:
            np.testing.assert_allclose(c2.gemm(A, B, tile="auto").array(),
                                       A @ B, **TOL)
            rep2 = c2.tuning_report()
        assert rep1["sweeps"] > 0 and rep1["cache_hits"] == 0
        assert rep2["sweeps"] == 0 and rep2["cache_hits"] == 1
        assert rep2["entries"][0]["source"] == "cache"
        assert rep2["fingerprint"] == rep1["fingerprint"]
        reps.append((rep1, rep2))
    for ref_rep, rep in zip(reps[0], reps[1]):
        _same_report(ref_rep, rep)
        assert rep["applied"] == ref_rep["applied"]
        assert rep["fingerprint"] == ref_rep["fingerprint"]


def test_auto_tune_default_applies_to_raw_arrays_only():
    A = np.random.default_rng(4).standard_normal((300, 300))
    with BlasxContext(_cfg(), auto_tune=True, tile=100) as ctx:
        Ah = ctx.tile(A)
        assert ctx.gemm(Ah, Ah).tile == 100          # the handle wins
        assert ctx.tuning_report()["sweeps"] == 0
        out = ctx.syrk(A)                            # raw array: tuned
        rep = ctx.tuning_report()
        assert rep["sweeps"] > 0
        assert out.tile == rep["entries"][-1]["tile"]
    with RefContext(RefConfig(**_kw()), auto_tune=True, tile=100) as ref:
        ref.syrk(A)
        _same_report(ref.tuning_report(), rep)


def test_tile_auto_conflicts_with_mismatched_handle_and_bad_strings():
    A = np.random.default_rng(5).standard_normal((300, 300))
    with BlasxContext(_cfg(), tile=100) as ctx:
        Ah = ctx.tile(A)
        tuned = ctx.auto_tile("gemm", 300, 300, 300)
        assert tuned != Ah.tile
        with pytest.raises(ValueError, match="tile"):
            ctx.gemm(Ah, Ah, tile="auto")
        with pytest.raises(ValueError, match="auto_tile"):
            ctx.tile(np.eye(8), tile="auto")
        with pytest.raises(ValueError, match="int or 'auto'"):
            ctx.gemm(np.eye(8), np.eye(8), tile="widest")
    with RefContext(RefConfig(**_kw()), tile=100) as ref:
        assert ref.auto_tile("gemm", 300, 300, 300) == tuned


def test_cold_context_adopts_tuned_schedule():
    A = np.random.default_rng(6).standard_normal((520, 520))
    L = np.tril(A) + 520 * np.eye(520)
    with BlasxContext(_cfg(), auto_tune=True) as ctx:
        out = ctx.trsm(L, A, uplo="L", tile="auto")
        np.testing.assert_allclose(out.array(),
                                   blas3.ref_trsm(L, A, uplo="L").numpy(),
                                   rtol=1e-8, atol=1e-8)
        rep = ctx.tuning_report()
        entry, applied = rep["entries"][0], rep["applied"]
        assert applied["n_streams"] == entry["n_streams"]
        assert applied["policy"] == entry["policy"]
        assert ctx.cfg.n_streams == entry["n_streams"]
        assert ctx.runtime.cfg is ctx.cfg
    with RefContext(RefConfig(**_kw()), auto_tune=True) as ref:
        ref.trsm(L, A, uplo="L", tile="auto")
        assert ref.tuning_report()["applied"] == applied
        assert ref.calls[0].makespan == ctx.calls[0].makespan


def test_warm_context_never_reconfigures_schedule():
    A = np.random.default_rng(7).standard_normal((300, 300))
    with BlasxContext(_cfg(), auto_tune=True) as ctx:
        ctx.gemm(A, A, tile=100)         # cold -> executed, caches warm
        rt = ctx.runtime
        ctx.gemm(A, A, tile="auto")      # tuned call on a warm context
        assert ctx.runtime is rt


# --------------------------------------------------------- other surfaces
def test_tile_auto_through_legacy_cblas_and_batch():
    from repro.api import cblas_dgemm as ref_cblas_dgemm
    from repro.core import blas3 as ref_blas3
    rng = np.random.default_rng(8)
    A = rng.standard_normal((200, 200))
    B = rng.standard_normal((200, 200))
    r = blas3.gemm(A, B, tile="auto", config=_cfg())
    np.testing.assert_allclose(r, A @ B, **TOL)
    ref_blas3.gemm(A, B, tile="auto", config=RefConfig(**_kw()))
    with BlasxContext(_cfg(), auto_tune=True) as ctx:
        C = np.zeros((200, 200))
        cblas_dgemm(CblasRowMajor, CblasNoTrans, CblasNoTrans, 200, 200,
                    200, 1.0, A, 200, B, 200, 0.0, C, 200, tile="auto",
                    ctx=ctx)
        np.testing.assert_allclose(C, A @ B, **TOL)
        outs = ctx.gemm_batched([A, B], [B, A], tile="auto")
        np.testing.assert_allclose(outs[0].array(), A @ B, **TOL)
        np.testing.assert_allclose(outs[1].array(), B @ A, **TOL)
        assert outs[0].tile == outs[1].tile   # one tuned tile, whole batch
        y = ctx.gemm_strided_batched(np.stack([A, B]), B, tile="auto")
        np.testing.assert_allclose(y[0], A @ B, **TOL)
        rep = ctx.tuning_report()
    with RefContext(RefConfig(**_kw()), auto_tune=True) as ref:
        ref_cblas_dgemm(CblasRowMajor, CblasNoTrans, CblasNoTrans, 200, 200,
                        200, 1.0, A, 200, B, 200, 0.0, np.zeros((200, 200)),
                        200, tile="auto", ctx=ref)
        ref.gemm_batched([A, B], [B, A], tile="auto")
        ref.gemm_strided_batched(np.stack([A, B]), B, tile="auto")
        _same_report(ref.tuning_report(), rep)


def test_tile_auto_side_r_reduction():
    rng = np.random.default_rng(9)
    A = rng.standard_normal((96, 96))
    B = rng.standard_normal((64, 96))
    r = blas3.trmm(A, B, side="R", tile="auto", config=_cfg())
    np.testing.assert_allclose(r, blas3.ref_trmm(A, B, side="R").numpy(),
                               rtol=1e-9, atol=1e-9)


# ------------------------------------------------------- learned cost model
_MODEL_KW = dict(tiles=(128, 256, 512), streams=(2, 4),
                 policies=("blasx", "static"))
_SIZES = (256, 384, 768, 1536, (1500, 150, 1500))


def _seed(tuner, routines=("gemm",)):
    for routine in routines:
        for m in _SIZES:
            tuner.tune(routine, *(m if isinstance(m, tuple) else (m, m, m)))
    return tuner


@pytest.fixture(scope="module")
def seeded_caches():
    """The reference's and the port's cache entries after the same
    sweep of a training distribution: gemm then syrk, and the gemm
    part alone (what sweeping gemm alone leaves)."""
    ref, port = _tuners(mode="sweep", **_MODEL_KW)
    both = (_seed(ref, ("gemm", "syrk")).cache.snapshot(),
            _seed(port, ("gemm", "syrk")).cache.snapshot())
    gemm = tuple({k: v for k, v in entries.items() if "/gemm/" in k}
                 for entries in both)
    return {("gemm", "syrk"): both, ("gemm",): gemm}


def _clone(entries, cls):
    cache = cls("")
    for key, entry in entries.items():
        cache.put(key, entry)
    return cache


def _seeded(seeded_caches, routines=("gemm",)):
    ref_entries, entries = seeded_caches[routines]
    return _clone(ref_entries, RefCache), _clone(entries, TuningCache)


def test_seeded_caches_and_models_equal_the_reference(seeded_caches):
    """Same sweep, same entries (keys mapped) and rows, so the same
    fitted model: coefficients and RMSE to the last bit."""
    ref_cache, cache = _seeded(seeded_caches, ("gemm", "syrk"))
    ref_entries, entries = ref_cache.snapshot(), cache.snapshot()
    assert {k.replace("/cuda/", "/numpy/") for k in entries} == \
        set(ref_entries)
    for key, entry in entries.items():
        want = ref_entries[key.replace("/cuda/", "/numpy/")]
        assert entry == want
    ref_t, port_t = _tuners(**_MODEL_KW)
    rows = training_rows(cache, port_t.fingerprint, "cuda",
                         port_t.cfg.topology())
    ref_rows = ref_training_rows(ref_cache, ref_t.fingerprint, "numpy",
                                 ref_t.cfg.topology())
    assert rows == ref_rows
    model = CostModel().fit(rows)
    from repro.tuning import CostModel as RefCostModel
    assert model.state() == RefCostModel().fit(ref_rows).state()


def test_auto_mode_bootstraps_through_sweeps_then_adopts():
    ref, port = _tuners(mode="auto", **_MODEL_KW)
    for t in (ref, port):
        first = t.tune("gemm", 256, 256, 256)
        assert first.source == "swept" and t.model_fallbacks == 1
        for m in (384, 768, 1536):
            t.tune("gemm", m, m, m)
        assert t.bucket_sweeps >= 2
        assert t._model is not None and t._model.rmse <= t.max_model_rmse
        sweeps_before = t.sweeps
        best = t.tune("gemm", 3000, 3000, 3000)
        assert best.source == "model" and t.model_adoptions >= 1
        assert t.sweeps - sweeps_before <= 2
        assert best.makespan <= best.default_makespan * (1 + 1e-12)
    _same_report(ref.report(), port.report())


def test_model_mode_confirmation_runs_only(seeded_caches):
    ref_cache, cache = _seeded(seeded_caches)
    ref, port = _tuners(cache=cache, ref_cache=ref_cache, mode="model",
                        **_MODEL_KW)
    want = ref.tune("gemm", 3000, 3000, 3000)
    best = port.tune("gemm", 3000, 3000, 3000)
    assert best.source == "model"
    assert port.sweeps == port.confirmations <= 2
    assert port.bucket_sweeps == 0
    assert best.makespan <= best.default_makespan * (1 + 1e-12)
    assert _pick(best) == _pick(want)


def test_model_adoption_is_disproved_by_confirmation(seeded_caches,
                                                     monkeypatch):
    """A model that predicts the measured-worst candidate is caught by
    the confirmation run and the tuner falls back to the full sweep."""
    _, cache = _seeded(seeded_caches)
    t = Autotuner(_cfg(execute=False, record_trace=False), cache=cache,
                  mode="model", **_MODEL_KW)
    model = t._ensure_model()
    assert model is not None
    bucket = (512, 128, 512)
    cands = t._candidates("gemm", bucket)
    spans = {c: t._shadow_makespan("gemm", bucket, c[0], "float64",
                                   c[1], c[2], c[3]) for c in cands}
    worst = max(cands, key=spans.get)
    assert spans[worst] > spans[cands[0]]

    def fake_predict(feats):
        tile = round(2 ** feats["ltile"])
        ns = round(2 ** feats["lstreams"])
        policy = next(p for p in ("blasx", "static", "parsec", "cublasxt")
                      if feats.get(f"policy_{p}"))
        wc = bool(feats.get("work_centric"))
        return 0.0 if (tile, ns, policy, wc) == worst else 1.0

    monkeypatch.setattr(model, "predict", fake_predict)
    best = t.tune("gemm", 512, 100, 512)
    assert t.model_fallbacks == 1 and best.source == "swept"
    assert best.makespan <= best.default_makespan * (1 + 1e-12)


def test_model_trains_only_on_measured_rows(seeded_caches):
    _, cache = _seeded(seeded_caches)
    t = Autotuner(_cfg(execute=False, record_trace=False), cache=cache,
                  mode="model", **_MODEL_KW)
    rows_before = len(training_rows(cache, t.fingerprint, t.cfg.backend,
                                    t.cfg.topology()))
    best = t.tune("gemm", 3000, 3000, 3000)
    assert best.source == "model"
    entry = cache.get(best.key)
    assert 1 <= len(entry["candidates"]) <= 2
    assert "predicted" in entry
    rows_after = len(training_rows(cache, t.fingerprint, t.cfg.backend,
                                   t.cfg.topology()))
    assert rows_after == rows_before + len(entry["candidates"])


def test_model_state_persists_in_cache_file(seeded_caches, tmp_path):
    path = str(tmp_path / "tuning.json")
    cache = TuningCache(path)
    for key, entry in seeded_caches[("gemm",)][1].items():
        cache.put(key, entry)
    t = Autotuner(_cfg(execute=False, record_trace=False), cache=cache,
                  mode="model", **_MODEL_KW)
    assert t.tune("gemm", 3000, 3000, 3000).source == "model"
    with open(path) as f:
        assert json.load(f)["model"]["trained"] is True
    cold = Autotuner(_cfg(execute=False, record_trace=False),
                     cache=TuningCache(path), mode="model", **_MODEL_KW)
    assert cold._model is not None and cold._model.trained
    best = cold.tune("syrk", 2000, 500)
    assert best.source == "model" and cold.bucket_sweeps == 0


def test_cost_model_state_roundtrip_and_malformed_state(seeded_caches):
    _, cache = _seeded(seeded_caches, ("gemm", "syrk"))
    t = Autotuner(_cfg(execute=False, record_trace=False), cache=cache)
    rows = training_rows(cache, t.fingerprint, t.cfg.backend,
                         t.cfg.topology())
    model = CostModel().fit(rows)
    assert model.trained and model.n_rows == len(rows)
    clone = CostModel.from_state(model.state())
    feats = rows[7]["features"]
    assert clone.predict(feats) == pytest.approx(model.predict(feats))
    lo, hi = model.interval(feats)
    assert lo <= model.predict(feats) <= hi
    assert not CostModel.from_state(None).trained
    assert not CostModel.from_state({"schema": 999}).trained
    assert not CostModel.from_state(
        {"schema": 1, "trained": True, "coef": "garbage"}).trained
    with pytest.raises(RuntimeError, match="not trained"):
        CostModel().predict(feats)


def test_bfloat16_features_use_its_itemsize():
    """numpy has no bfloat16: the port reads the itemsize from torch,
    so a bf16 bucket's features equal an f16 bucket's."""
    from repro_torch.tuning import features
    topo = _cfg().topology()
    f16 = features("gemm", (512, 512, 512), "float16", topo, 128, 2, "blasx")
    bf16 = features("gemm", (512, 512, 512), "bfloat16", topo, 128, 2,
                    "blasx")
    assert bf16 == f16 and bf16["litemsize"] == 1.0


def test_autotuner_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        Autotuner(_cfg(execute=False), cache=TuningCache(""), mode="bogus")
    with pytest.raises(ValueError, match="auto_tune"):
        BlasxContext(_cfg(), auto_tune="bogus")
    with pytest.raises(TypeError, match="tuning_cache"):
        Autotuner(_cfg(execute=False), cache=42)


def test_context_threads_auto_tune_mode(seeded_caches):
    ref_cache, cache = _seeded(seeded_caches)
    A = np.random.default_rng(10).standard_normal((3000, 300))
    reps = []
    for Ctx, cfg, c in ((RefContext, RefConfig(**_kw()), ref_cache),
                        (BlasxContext, _cfg(), cache)):
        with Ctx(cfg, auto_tune="auto", tuning_cache=c) as ctx:
            assert ctx.tuning_report()["mode"] == "auto"
            out = ctx.gemm(A, A.T)
            np.testing.assert_allclose(out.array(), A @ A.T, **TOL)
            rep = ctx.tuning_report()
            assert rep["model_adoptions"] == 1 and rep["bucket_sweeps"] == 0
            reps.append(rep)
    _same_report(*reps)
    with BlasxContext(_cfg(), auto_tune=True) as ctx:
        assert ctx.tuning_report()["mode"] == "sweep"


# ------------------------------------------------- provenance-split counters
def test_tuning_report_provenance_counts(tmp_path):
    reps = []
    for name, (cache_cls, tuner_cls, cfg) in {
            "ref": (RefCache, RefAutotuner, RefConfig(**_shadow_kw())),
            "port": (TuningCache, Autotuner,
                     RuntimeConfig(device="cpu", **_shadow_kw()))}.items():
        path = str(tmp_path / f"{name}.json")
        tuner_cls(cfg, cache=path, **_MODEL_KW).tune("gemm", 256, 256, 256)
        t = tuner_cls(cfg, cache=cache_cls(path), **_MODEL_KW)
        t.tune("gemm", 256, 256, 256)      # hit, origin "file"
        t.tune("syrk", 256, 256, 256)      # miss -> sweep
        t.tune("syrk", 200, 200, 200)      # hit, origin "process"
        reps.append(t.report())
    rep = reps[1]
    assert (rep["cache_hits"], rep["file_cache_hits"],
            rep["process_cache_hits"], rep["bucket_sweeps"]) == (2, 1, 1, 1)
    assert rep["model_adoptions"] == 0 and rep["model_fallbacks"] == 0
    assert [e["source"] for e in rep["entries"]] == \
        ["cache-file", "swept", "cache"]
    _same_report(*reps)


def test_tuning_report_before_any_tuning():
    with BlasxContext(_cfg()) as ctx, RefContext(RefConfig(**_kw())) as ref:
        assert ctx.tuning_report() == ref.tuning_report() == {
            "enabled": False, "mode": "sweep", "sweeps": 0,
            "bucket_sweeps": 0, "confirmations": 0, "cache_hits": 0,
            "file_cache_hits": 0, "process_cache_hits": 0,
            "model_adoptions": 0, "model_fallbacks": 0, "cache_entries": 0,
            "entries": []}
