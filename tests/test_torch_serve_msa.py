"""The port's MSA service (``repro_torch.serve``) against the reference's.

Every case of ``tests/test_serve.py``, the service cases of
``tests/test_obs.py``, the service's ``/tree`` refine keys
(``tests/test_phylo_ml.py``) and ``/search`` (``tests/test_search.py``):
the same requests, on numpy-seeded families of 3-12 sequences of 60-250
nt, go to ``repro.serve.MSAService`` and to the port's
``MSAService(ServiceConfig(device="cpu"))``. Equal exactly: ``msa_id``,
rows, widths, centers, paths, ``add`` results, ``search_id`` and hits,
the coalescer's batch counts and every ``/healthz`` field but the route
name (``backend``: the port's ``torch``, the reference's ``jnp``). Newick
strings are equal, or RF 0 where NJ roots a tie apart (ROADMAP.md §3);
the logL of ``refine: ml`` agrees at rtol 1e-5. Also: the service and its
launcher refuse a missing card, a concurrent ``/align`` succeeds while a
``/tree`` runs under deterministic algorithms, and one HTTP round trip
per server, each shut down in a ``finally``.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.align.bucketing import pair_bucket_plan as j_plan
from repro.core.msa import MSAConfig as JConfig
from repro.core.msa import center_star_msa as j_csm
from repro.serve import AlignJob as JJob
from repro.serve import CoalescingAligner as JCo
from repro.serve import MSAService as JService
from repro.serve import ServiceConfig as JServiceConfig
from repro.serve.cache import canonical_key as j_key
from repro_torch.align.bucketing import _pow2_widths, pair_bucket_plan
from repro_torch.core.msa import MSAConfig, center_star_msa
from repro_torch.obs.metrics import REGISTRY, parse_exposition
from repro_torch.serve import (AlignJob, CoalescingAligner, MSAService,
                               ServiceConfig, add_to_msa, serve_http)
from repro_torch.serve.cache import ResultCache, canonical_key, canonicalize
from test_torch_msa_run import _splits, one_torch_thread  # noqa: F401

HTTP_TIMEOUT = 60


def _family(rng, n, length, nsub=3):
    base = "".join(rng.choice(list("ACGT"), length))
    out = [base]
    for _ in range(n - 1):
        s = list(base)
        for _ in range(nsub):
            s[rng.integers(0, len(s))] = "ACGT"[rng.integers(0, 4)]
        out.append("".join(s))
    return out


def _cfgs(**kw):
    """The reference's and the port's ServiceConfig for the same knobs."""
    return JServiceConfig(**kw), ServiceConfig(**kw, device="cpu")


def _same_alignment(a, b):
    for k in ("msa_id", "names", "rows", "width", "center_idx"):
        assert a[k] == b[k], k


def _same_tree(a: str, b: str, names):
    """Equal Newick, or RF 0 (an NJ tie rooted apart)."""
    if a != b:
        assert _splits(a, names) == _splits(b, names)


def _total(name: str) -> float:
    snap = REGISTRY.snapshot()
    return sum(s["value"]
               for s in snap.get(name, {"samples": []})["samples"])


def _post(port, path, obj, timeout=HTTP_TIMEOUT):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path, timeout=HTTP_TIMEOUT) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.read().decode()


class _Server:
    """``serve_http`` on a thread; ``close`` shuts it down and drains."""

    def __init__(self, svc):
        self.svc = svc
        self.httpd = serve_http(svc, "127.0.0.1", 0)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if not self.svc._draining:
            self.svc.drain()


# ------------------------------------------------------------- align_pairs

def _pairs_inputs(seed, qn, tn, gap=5):
    rng = np.random.default_rng(seed)
    qs = [rng.integers(0, 4, n).astype(np.int8) for n in qn]
    ts = [rng.integers(0, 4, n).astype(np.int8) for n in tn]
    Q = np.full((len(qs), max(qn)), gap, np.int8)
    T = np.full((len(ts), max(tn)), gap, np.int8)
    for i, (q, t) in enumerate(zip(qs, ts)):
        Q[i, :len(q)] = q
        T[i, :len(t)] = t
    return Q, np.array(qn, np.int32), T, np.array(tn, np.int32)


def test_align_pairs_matches_broadcast_path_and_reference():
    Q, ql, T, tl = _pairs_inputs(0, (20, 33, 70, 140), (25, 40, 60, 130))
    eng = MSAConfig(method="plain").engine("cpu")
    ref = JConfig(method="plain").engine().align_pairs(Q, ql, T, tl)
    res = eng.align_pairs(Q, ql, T, tl)
    assert res.n_calls == ref.n_calls
    for i in range(4):
        one = eng.align_to_center(Q[i:i + 1, :ql[i]], ql[i:i + 1],
                                  T[i, :tl[i]], tl[i])
        k = int(res.aln_len[i])
        assert k == int(ref.aln_len[i])
        assert float(one.score[0]) == float(res.score[i]) \
            == float(ref.score[i])
        for got in (one.a_row[0], res.a_row[i]):
            assert np.array_equal(got[:k].numpy(),
                                  np.asarray(ref.a_row[i][:k]))
        for got in (one.b_row[0], res.b_row[i]):
            assert np.array_equal(got[:k].numpy(),
                                  np.asarray(ref.b_row[i][:k]))


def test_align_pairs_banded_overflow_falls_back():
    rng = np.random.default_rng(1)
    t = rng.integers(0, 4, 80).astype(np.int8)
    q = np.concatenate([t[:10], t[40:]])
    Q = np.full((1, 80), 5, np.int8)
    Q[0, :q.size] = q
    args = (Q, np.array([q.size], np.int32), t[None, :],
            np.array([80], np.int32))
    band = MSAConfig(method="plain", backend="banded", band=4)
    res = band.engine("cpu").align_pairs(*args)
    full = MSAConfig(method="plain").engine("cpu").align_pairs(*args)
    ref = JConfig(method="plain", backend="banded",
                  band=4).engine().align_pairs(*args)
    assert res.n_fallback >= 1 and res.n_fallback == ref.n_fallback
    assert float(res.score[0]) == float(full.score[0]) \
        == float(ref.score[0])


def test_pair_bucket_plan_bounds_shapes():
    rng = np.random.default_rng(2)
    qlens = rng.integers(10, 500, 300)
    tlens = rng.integers(10, 500, 300)
    plan = pair_bucket_plan(qlens, tlens, 500, 500)
    ref = j_plan(qlens, tlens, 500, 500)
    assert [(a, b, i.tolist()) for a, b, i in plan] == \
        [(a, b, np.asarray(i).tolist()) for a, b, i in ref]
    wq = _pow2_widths(qlens, 500, 32)
    wt = _pow2_widths(tlens, 500, 32)
    assert len(plan) == len(set(zip(wq.tolist(), wt.tolist())))
    for q_w, t_w, idx in plan:
        assert (qlens[idx] <= q_w).all() and (tlens[idx] <= t_w).all()


# ------------------------------------------------------------- coalescing

def _jobs(seed, n, engine, job_cls):
    rng = np.random.default_rng(seed)
    jobs, lens = [], []
    for _ in range(n):
        L = int(rng.integers(20, 250))
        t = rng.integers(0, 4, L).astype(np.int8)
        q = t.copy()
        q[rng.integers(0, L, 3)] = rng.integers(0, 4, 3).astype(np.int8)
        jobs.append(job_cls(Q=q[None, :], qlens=np.array([L], np.int32),
                            target=t, tlen=L, engine=engine,
                            engine_key="k"))
        lens.append(L)
    return jobs, lens


def test_coalescing_merges_requests_into_bucket_count_calls():
    results, stats = {}, {}
    for name, co, eng, job in (
            ("port", CoalescingAligner,
             MSAConfig(method="plain").engine("cpu"), AlignJob),
            ("ref", JCo, JConfig(method="plain").engine(), JJob)):
        q = co(max_batch=10_000, max_wait_ms=100.0)
        jobs, lens = _jobs(3, 12, eng, job)
        futs = [q.submit(j) for j in jobs]
        results[name] = [f.result(timeout=120) for f in futs]
        stats[name] = q.stats()
        q.close()
    n_buckets = len(pair_bucket_plan(np.array(lens), np.array(lens),
                                     max(lens), max(lens)))
    st = stats["port"]
    assert st["batches"] == 1
    assert st["engine_calls"] <= n_buckets < 12
    assert st["coalesced_jobs"] == 12
    assert st == stats["ref"]
    for got, ref in zip(results["port"], results["ref"]):
        assert got.meta == ref.meta and got.meta["batch_jobs"] == 12
        k = int(got.aln_len[0])
        assert k == int(ref.aln_len[0])
        assert float(got.score[0]) == float(ref.score[0])
        assert np.array_equal(got.a_row[0][:k], np.asarray(ref.a_row[0][:k]))
        assert np.array_equal(got.b_row[0][:k], np.asarray(ref.b_row[0][:k]))


def test_coalescer_drain_completes_inflight_then_refuses():
    engine = MSAConfig(method="plain").engine("cpu")
    co = CoalescingAligner(max_batch=10_000, max_wait_ms=30_000.0)
    Q = (np.arange(16) % 4).astype(np.int8)[None, :]
    t = (np.arange(16) % 4).astype(np.int8)

    def job():
        return AlignJob(Q=Q, qlens=np.array([16], np.int32), target=t,
                        tlen=16, engine=engine, engine_key="k")
    futs = [co.submit(job()) for _ in range(3)]
    t0 = time.perf_counter()
    co.close()
    assert time.perf_counter() - t0 < 20             # not the 30s deadline
    assert all(f.done() for f in futs)
    for f in futs:
        assert f.result().a_row.shape[0] == 1
        assert isinstance(f.result().a_row, np.ndarray)
    with pytest.raises(RuntimeError, match="draining"):
        co.submit(job())


def test_coalescer_failure_fails_every_future_and_counts():
    class BoomEngine:
        gap_code = 5
        device = torch.device("cpu")

        def align_pairs(self, *a, **k):
            raise RuntimeError("boom")

    b0 = _total("repro_failed_batches_total")
    co = CoalescingAligner(max_batch=2, max_wait_ms=1.0)
    fut = co.submit(AlignJob(Q=np.zeros((2, 8), np.int8),
                             qlens=np.full(2, 8, np.int32),
                             target=np.zeros(8, np.int8), tlen=8,
                             engine=BoomEngine(), engine_key="x"))
    with pytest.raises(RuntimeError, match="boom"):
        fut.result(timeout=30)
    co.close()
    st = co.stats()
    assert (st["failed_batches"], st["failed_pairs"], st["in_flight"]) \
        == (1, 2, 0)
    assert _total("repro_failed_batches_total") - b0 == 1


# ------------------------------------------------------------------ cache

def test_result_cache_lru_and_byte_budget():
    c = ResultCache(max_bytes=100, max_items=10)
    c.put("a", 1, 40)
    c.put("b", 2, 40)
    assert c.get("a") == 1
    c.put("c", 3, 40)                       # evicts 'b' (LRU)
    assert c.get("b") is None
    assert c.get("a") == 1 and c.get("c") == 3
    s = c.stats()
    assert s["evictions"] == 1 and s["bytes"] <= 100
    assert s["hits"] == 3 and s["misses"] == 1


@pytest.mark.parametrize("seqs,fp,center", [
    (["AAC", "GGT"], "dna/plain", None), (["GGT", "AAC"], "dna/plain", None),
    (["AAC", "GGT"], "dna/plain", "AAC"), (["ACGT"] * 3, "", None),
    (["ACGTN", "A-C"], "protein/kmer/auto/64/11/first/11/1", "A-C")])
def test_canonical_key_is_the_reference_digest(seqs, fp, center):
    assert canonical_key(seqs, fp, center=center) == \
        j_key(seqs, fp, center=center)
    assert canonical_key(["AAC", "GGT"], fp) == canonical_key(
        ["GGT", "AAC"], fp)
    assert canonical_key(["AAC", "GGT"], fp) != canonical_key(
        ["AAC", "GGT"], fp, center="AAC")
    canon, perm = canonicalize(["GGT", "AAC"])
    assert canon == ["AAC", "GGT"] and perm == [1, 0]


# ---------------------------------------------------------------- service

@pytest.fixture(scope="module")
def services():
    """The reference's and the port's service, same configuration."""
    jc, tc = _cfgs(max_wait_ms=20.0)
    ref, port = JService(jc), MSAService(tc)
    yield ref, port
    for svc in (ref, port):
        if not svc._draining:
            svc.drain()


def test_service_concurrent_aligns_coalesce_and_match_reference(services):
    ref, port = services
    rng = np.random.default_rng(4)
    fams = [_family(rng, 4, 100) for _ in range(5)]
    results = [None] * len(fams)

    def call(i):
        results[i] = port.align([f"s{j}" for j in range(4)], fams[i])

    before = port.coalescer.stats()["engine_calls"]
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(fams))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    cfg = MSAConfig(method="plain")
    for fam, resp in zip(fams, results):
        want = ref.align([f"s{j}" for j in range(4)], fam)
        _same_alignment(resp["alignment"], want["alignment"])
        assert resp["path"] == want["path"] == "coalesced"
        canon, _ = canonicalize(fam)
        entry = port.cache.peek(resp["alignment"]["msa_id"])
        assert np.array_equal(entry["msa"],
                              center_star_msa(canon, cfg, device="cpu").msa)
        assert np.array_equal(entry["msa"], np.asarray(j_csm(
            canon, JConfig(method="plain")).msa))
        for s, row in zip(fam, resp["alignment"]["rows"]):
            assert row.replace("-", "") == s
    # 5 requests x 3 queries each: far fewer engine calls than requests
    assert port.coalescer.stats()["engine_calls"] - before < len(fams)


def test_service_cache_hit_is_byte_identical(services):
    ref, port = services
    fam = _family(np.random.default_rng(5), 4, 90)
    names = [f"n{j}" for j in range(4)]
    r1, r2 = port.align(names, fam), port.align(names, fam)
    assert r1["cached"] is False and r2["cached"] is True
    assert json.dumps(r1["alignment"]) == json.dumps(r2["alignment"])
    _same_alignment(r1["alignment"], ref.align(names, fam)["alignment"])
    order = [2, 0, 3, 1]
    r3 = port.align([names[i] for i in order], [fam[i] for i in order])
    assert r3["cached"] is True
    assert r3["alignment"]["rows"] == [r1["alignment"]["rows"][i]
                                       for i in order]


def test_service_tree_and_tree_cache(services):
    ref, port = services
    fam = _family(np.random.default_rng(6), 5, 80)
    names = [f"t{j}" for j in range(5)]
    mid = port.align(names, fam)["alignment"]["msa_id"]
    assert mid == ref.align(names, fam)["alignment"]["msa_id"]
    t1, t2 = port.tree(msa_id=mid), port.tree(msa_id=mid)
    want = ref.tree(msa_id=mid)
    assert t1["cached_tree"] is False and t2["cached_tree"] is True
    assert t1["newick"] == t2["newick"]
    assert t1["newick"].count("(") == 4                  # 5 leaves
    _same_tree(t1["newick"], want["newick"], names)
    for k in ("msa_id", "backend", "requested_backend", "refine",
              "n_leaves"):
        assert t1[k] == want[k], k
    with pytest.raises(KeyError):
        port.tree(msa_id="bogus")


def test_incremental_add_bit_identical_to_full_realign(services):
    ref, port = services
    rng = np.random.default_rng(7)
    base = "".join(rng.choice(list("ACGT"), 120))
    fam = [base, base[:50] + base[51:], base[:30] + "T" + base[30:]]
    new = [base[:10] + "ACGT" + base[10:], base[3:]]     # forces new columns
    mid = port.align(["a", "b", "c"], fam)["alignment"]["msa_id"]
    ref.align(["a", "b", "c"], fam)
    radd = port.align_add(mid, ["d", "e"], new)
    want = ref.align_add(mid, ["d", "e"], new)
    assert radd["add"] == want["add"] and radd["add"]["realigned"] is False
    assert radd["path"] == want["path"] == "incremental"
    _same_alignment(radd["alignment"], want["alignment"])
    canon, _ = canonicalize(fam)
    full = center_star_msa(canon + new, MSAConfig(method="plain"),
                           device="cpu")
    entry = port.cache.peek(radd["alignment"]["msa_id"])
    assert entry["width"] == full.width
    assert np.array_equal(entry["msa"][:len(fam)], full.msa[:len(fam)])
    assert np.array_equal(entry["msa"], full.msa)
    with pytest.raises(KeyError):
        port.align_add("bogus", ["x"], ["ACGT"])


def test_incremental_drift_triggers_full_realign():
    cfg = MSAConfig(method="plain")
    base = "".join(np.random.default_rng(8).choice(list("ACGT"), 80))
    prev = center_star_msa([base, base[:40] + base[41:]], cfg, device="cpu")
    new = [base[:10] + "ACGTACGTACGT" + base[10:]]
    res = add_to_msa(prev.msa, prev.center_idx, new, cfg,
                     drift_threshold=0.01, device="cpu")
    assert res.realigned is True
    full = center_star_msa([base, base[:40] + base[41:]] + new, cfg,
                           device="cpu")
    assert np.array_equal(res.msa, full.msa)
    from repro.serve import add_to_msa as j_add
    want = j_add(prev.msa, prev.center_idx, new, JConfig(method="plain"),
                 drift_threshold=0.01)
    assert np.array_equal(res.msa, np.asarray(want.msa))
    assert (res.width, res.growth) == (want.width, want.growth)


@pytest.mark.parametrize("alpha", ["DNA", "PROTEIN"])
def test_decode_equals_reference(alpha):
    """The port's row decoding (``decode``, one lookup table, and
    ``decode_msa`` over it) against the reference alphabet's ``decode``,
    row by row, gap and negative codes included."""
    from repro.core import alphabet as jab
    from repro_torch.core import alphabet as ab
    from repro_torch.core.msa import MSAConfig, decode_msa
    a, j = getattr(ab, alpha), getattr(jab, alpha)
    rows = np.random.default_rng(3).integers(
        -1, a.gap_code + 1, (7, 33)).astype(np.int8)
    want = [j.decode(r) for r in rows]
    assert [a.decode(r) for r in rows] == want
    assert decode_msa(rows, MSAConfig(alphabet=alpha.lower())) == want
    assert a.decode(rows[0, :0]) == "" and decode_msa(rows[:0],
                                                     MSAConfig()) == []


def test_json_and_fasta_payloads_normalize_identically():
    from repro.serve.service import parse_sequences as j_parse
    from repro_torch.serve.service import parse_sequences
    fasta = {"fasta": ">a\nac.gt\r\nACGT\n"}
    js = {"sequences": ["ac.gt\rACGT"], "names": ["a"]}
    assert parse_sequences(fasta)[1] == parse_sequences(js)[1] \
        == ["AC-GTACGT"]
    assert parse_sequences(fasta) == j_parse(fasta)
    assert parse_sequences(js) == j_parse(js)
    with pytest.raises(ValueError, match="invalid character"):
        parse_sequences({"sequences": ["AC4GT"]})


def test_tree_from_sequences_survives_cache_eviction():
    # byte budget smaller than any entry: every put self-evicts, so the
    # tree path must use the entry it just computed, not re-resolve it
    jc, tc = _cfgs(max_wait_ms=1.0, cache_bytes=1)
    fam = _family(np.random.default_rng(10), 3, 60)
    svc, ref = MSAService(tc), JService(jc)
    try:
        resp = svc.tree(names=["a", "b", "c"], seqs=fam)
        assert resp["newick"].endswith(";")
        want = ref.tree(names=["a", "b", "c"], seqs=fam)
        assert resp["msa_id"] == want["msa_id"]
        _same_tree(resp["newick"], want["newick"], ["a", "b", "c"])
    finally:
        svc.drain()
        ref.drain()


def test_align_add_hit_credits_caller_names(services):
    ref, port = services
    rng = np.random.default_rng(11)
    fam = _family(rng, 3, 70)
    new = [_family(rng, 1, 70)[0]]
    mid = port.align(["a", "b", "c"], fam)["alignment"]["msa_id"]
    r1 = port.align_add(mid, ["first"], new)
    r2 = port.align_add(mid, ["second"], new)
    assert r1["cached"] is False and r2["cached"] is True
    assert r1["alignment"]["names"][-1] == "first"
    assert r2["alignment"]["names"][-1] == "second"
    assert r1["alignment"]["rows"] == r2["alignment"]["rows"]
    ref.align(["a", "b", "c"], fam)
    _same_alignment(r1["alignment"],
                    ref.align_add(mid, ["first"], new)["alignment"])


def test_service_drain_refuses_new_work():
    jc, tc = _cfgs(max_wait_ms=1.0)
    svc, ref = MSAService(tc), JService(jc)
    fam = _family(np.random.default_rng(9), 3, 60)
    svc.align(["a", "b", "c"], fam)
    ref.align(["a", "b", "c"], fam)
    want = ref.healthz()
    got = svc.healthz()
    assert set(got) == set(want)
    for k in set(got) - {"uptime_s", "backend"}:
        assert got[k] == want[k], k
    assert (got["backend"], want["backend"]) == ("torch", "jnp")
    svc.drain()
    ref.drain()
    with pytest.raises(RuntimeError, match="draining"):
        svc.align(["a", "b", "c"], fam)
    assert svc.healthz()["status"] == "draining"


def test_service_defaults_to_the_card_and_refuses_without_one(monkeypatch):
    import repro_torch.device as tdev
    from repro_torch.launch import serve_msa
    monkeypatch.setattr(tdev.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ServiceConfig()
    with pytest.raises(RuntimeError, match="is_available"):
        serve_msa.main(["--port", "0"])
    assert ServiceConfig.__dataclass_fields__["device"].default == "cuda"


def test_concurrent_align_succeeds_during_a_deterministic_tree():
    """A ``/tree`` with ``refine: search`` runs its fleet under
    ``torch.use_deterministic_algorithms`` (process-wide) while other
    requests keep aligning; they succeed and equal their results alone."""
    svc = MSAService(ServiceConfig(max_wait_ms=1.0, device="cpu"))
    try:
        rng = np.random.default_rng(21)
        fam = _family(rng, 5, 80, nsub=8)
        names = [f"d{i}" for i in range(5)]
        others = [_family(rng, 4, 90) for _ in range(4)]
        alone = MSAService(ServiceConfig(max_wait_ms=1.0, device="cpu"))
        want = [alone.align(["a", "b", "c", "d"], f)["alignment"]
                for f in others]
        alone.drain()
        seen, out = [], {}
        orig = torch.use_deterministic_algorithms

        def spy(mode, **kw):
            seen.append(mode)
            return orig(mode, **kw)

        torch.use_deterministic_algorithms = spy
        try:
            tree = threading.Thread(target=lambda: out.update(
                tree=svc.tree(names=names, seqs=fam, refine="search")))
            tree.start()
            got = []
            while tree.is_alive() and len(got) < len(others):
                got.append(svc.align(["a", "b", "c", "d"],
                                     others[len(got)])["alignment"])
            tree.join(300)
        finally:
            torch.use_deterministic_algorithms = orig
        assert True in seen and not torch.are_deterministic_algorithms_enabled()
        assert out["tree"]["refine"] == "search"
        assert got, "no /align ran while the tree was built"
        for g, w in zip(got, want):
            _same_alignment(g, w)
    finally:
        svc.drain()


# ------------------------------------------------------------ tree refine

def test_service_tree_refine_fingerprint():
    rng = np.random.default_rng(6)
    seqs = _family(rng, 6, 120, nsub=10)
    jc, tc = _cfgs(method="plain")
    svc, ref = MSAService(tc), JService(jc)
    try:
        r1 = svc.tree(seqs=seqs, refine="ml", model="jc69")
        w1 = ref.tree(seqs=seqs, refine="ml", model="jc69")
        assert r1["refine"] == "ml" and r1["model"] == w1["model"]
        assert r1["logl"]["final"] >= r1["logl"]["initial"]
        for k in ("initial", "final"):
            np.testing.assert_allclose(r1["logl"][k], w1["logl"][k],
                                       rtol=1e-5)
        assert r1["msa_id"] == w1["msa_id"]
        r2 = svc.tree(msa_id=r1["msa_id"], refine="ml", model="jc69")
        assert r2["cached_tree"]
        r3 = svc.tree(msa_id=r1["msa_id"])
        assert not r3["cached_tree"] and r3["refine"] == "none"
        assert svc.tree(msa_id=r1["msa_id"], model="gtr")["cached_tree"]
        assert not svc.tree(msa_id=r1["msa_id"], seed=99)["cached_tree"]
        with pytest.raises(ValueError):
            svc.tree(msa_id=r1["msa_id"], bootstrap=10)
    finally:
        svc.drain()
        ref.drain()
    # a server-wide bootstrap default must not leak into requests that
    # override refine to "none"
    svc2 = MSAService(ServiceConfig(method="plain", tree_refine="ml",
                                    tree_model="jc69", tree_bootstrap=4,
                                    device="cpu"))
    try:
        r6 = svc2.tree(seqs=seqs, refine="none")
        assert r6["refine"] == "none" and "logl" not in r6
    finally:
        svc2.drain()


# ------------------------------------------------------------------ search

def _planted():
    rng = np.random.default_rng(0)

    def rseq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    def mut(s, p=0.06):
        return "".join("ACGT"[rng.integers(0, 4)] if rng.random() < p
                       else x for x in s)
    base = rseq(150)
    names = [f"fam_m{j}" for j in range(4)] + [f"decoy{j}" for j in range(6)]
    seqs = [mut(base) for _ in range(4)] + [rseq(150) for _ in range(6)]
    return names, seqs, mut(base)


def test_service_search_endpoint_caches_and_maps_order():
    from repro.search import SearchIndex as JIndex
    from repro_torch.search import SearchIndex
    names, db, query = _planted()
    index = SearchIndex.build(names, db, device="cpu")
    jindex = JIndex.build(names, db)
    assert index.fingerprint() == jindex.fingerprint()
    svc = MSAService(ServiceConfig(search_index=index, device="cpu"))
    ref = JService(JServiceConfig(search_index=jindex))
    try:
        qn, qs = ["q0", "q1"], [query, "ACGTACGTACGT"]
        r1 = svc.search(qn, qs, max_evalue=1e-6)
        w1 = ref.search(qn, qs, max_evalue=1e-6)
        assert not r1["cached"]
        assert r1["search_id"] == w1["search_id"]
        assert r1["queries"] == w1["queries"]
        assert r1["stats"] == w1["stats"]
        assert r1["queries"][0]["hits"][0]["target"].startswith("fam_")
        r2 = svc.search(list(reversed(qn)), list(reversed(qs)),
                        max_evalue=1e-6)
        assert r2["cached"]
        assert r2["queries"][1]["name"] == "q0"
        assert r2["queries"][1]["hits"] == r1["queries"][0]["hits"]
        assert svc.healthz()["search_db"] == index.n_seqs
    finally:
        svc.drain()
        ref.drain()
    svc_nodb = MSAService(ServiceConfig(device="cpu"))
    try:
        with pytest.raises(ValueError, match="no search database"):
            svc_nodb.search(qn, qs)
    finally:
        svc_nodb.drain()


# -------------------------------------------------------------------- HTTP

def test_http_roundtrip_and_graceful_shutdown():
    jc, tc = _cfgs(max_wait_ms=2.0)
    srv, ref = _Server(MSAService(tc)), JService(jc)
    try:
        health = json.loads(_get(srv.port, "/healthz"))
        assert health["status"] == "ok" and health["backend"] == "torch"
        fasta = ">a\nACGTACGTAAGGCC\n>b\nacgtacgaaaggcc\r\n>c\nACGTTCGTAAGGC\n"
        st, resp = _post(srv.port, "/align", {"fasta": fasta})
        assert st == 200
        assert resp["alignment"]["rows"][1].replace("-", "") == \
            "ACGTACGAAAGGCC"                             # CRLF+lower fixed
        from repro.serve.service import parse_sequences as j_parse
        _same_alignment(resp["alignment"],
                        ref.align(*j_parse({"fasta": fasta}))["alignment"])
        mid = resp["alignment"]["msa_id"]
        st, tresp = _post(srv.port, "/tree", {"msa_id": mid})
        assert st == 200 and tresp["newick"].endswith(";")
        st, aresp = _post(srv.port, "/align/add",
                          {"msa_id": mid, "sequences": ["ACGTACGTAAGGC"],
                           "names": ["d"]})
        assert st == 200 and len(aresp["alignment"]["rows"]) == 4
        _same_alignment(aresp["alignment"], ref.align_add(
            mid, ["d"], ["ACGTACGTAAGGC"])["alignment"])
        assert _post(srv.port, "/tree", {"msa_id": "nope"})[0] == 404
        assert _post(srv.port, "/align", {"bogus": 1})[0] == 400
        assert _post(srv.port, "/align/add", {"sequences": ["AC"]})[0] == 400
        assert _post(srv.port, "/search", {"sequences": ["AC"]})[0] == 400
        assert _post(srv.port, "/nope", {})[0] == 404
        code, err = _post(srv.port, "/align?name=fam", {"sequences": ["AC"]})
        assert code == 400 and "store" in err["error"]
    finally:
        srv.close()
        ref.drain()
    assert srv.svc.coalescer.stats()["in_flight"] == 0


def test_metrics_and_statusz_endpoints():
    srv = _Server(MSAService(ServiceConfig(max_wait_ms=1.0, device="cpu")))
    try:
        st, resp = _post(srv.port, "/align",
                         {"sequences": ["ACGTACGTAA", "ACGTACGAAA"]})
        assert st == 200
        assert len(resp["trace_id"]) == 16
        fams = parse_exposition(_get(srv.port, "/metrics"))
        for required in ("repro_requests_started_total",
                         "repro_request_seconds", "repro_align_calls_total",
                         "repro_span_seconds"):
            assert required in fams, required
        statusz = _get(srv.port, "/statusz")
        assert "active_requests" in statusz
        assert "serve.align" in statusz
    finally:
        srv.close()


def test_http_drain_waits_for_inflight_then_rejects_with_503():
    svc = MSAService(ServiceConfig(max_wait_ms=1.0, device="cpu"))
    entered = {"tree": threading.Event(), "search": threading.Event()}
    release = {"tree": threading.Event(), "search": threading.Event()}

    def gated(kind, payload):
        def impl(*a, **k):
            entered[kind].set()
            assert release[kind].wait(30)
            return dict(payload)
        return impl

    svc._tree_impl = gated("tree", {"newick": "(a,b);"})
    svc._search_impl = gated("search", {"queries": [], "stats": {}})
    s0 = _total("repro_requests_started_total")
    f0 = _total("repro_requests_finished_total")
    r0 = _total("repro_requests_rejected_total")
    srv = _Server(svc)
    results = {}
    try:
        def client(key, path, obj):
            results[key] = _post(srv.port, path, obj)

        threads = [threading.Thread(target=client, args=(
            "tree", "/tree", {"sequences": ["ACGT", "ACGA", "AGGT"]})),
            threading.Thread(target=client, args=(
                "search", "/search", {"sequences": ["ACGTACGT"]}))]
        for t in threads:
            t.start()
        assert entered["tree"].wait(30) and entered["search"].wait(30)
        drain_done = {}
        drainer = threading.Thread(
            target=lambda: drain_done.update(ok=svc.drain(timeout=60)))
        drainer.start()
        time.sleep(0.3)
        assert drainer.is_alive(), "drain returned with requests in flight"
        assert _total("repro_requests_active") == 2
        client("late", "/align", {"sequences": ["ACGT", "ACGA"]})
        assert results["late"][0] == 503
        assert "draining" in results["late"][1]["error"]
        for ev in release.values():
            ev.set()
        for t in threads:
            t.join(30)
        drainer.join(30)
        assert drain_done.get("ok") is True
        assert results["tree"][0] == 200
        assert results["tree"][1]["newick"] == "(a,b);"
        assert results["tree"][1]["trace_id"]
        assert results["search"][0] == 200
    finally:
        for ev in release.values():
            ev.set()
        srv.close()
    started = _total("repro_requests_started_total") - s0
    finished = _total("repro_requests_finished_total") - f0
    rejected = _total("repro_requests_rejected_total") - r0
    assert started == 3 and finished == 2 and rejected == 1
    assert started == finished + rejected
    assert _total("repro_requests_active") == 0
