"""The port's persistent MSA store (``repro_torch.serve.store``) against the
reference's (``repro.serve.store``), on the CPU.

The cases of ``tests/test_store.py``, each held to the reference where it
computes something:

* create / add / restart, retention, bad names, the corrupt-latest
  fallback (torn bytes, a lying fingerprint);
* crash atomicity at every ``COMMIT_FAULT_LABELS`` entry after 0, 1 or 2
  clean adds: a fresh store over the directory restores exactly the
  previous generation (fault before the replace) or exactly the new one
  (at or after it), and ingestion continues;
* adds equal a cold full realign, per generation (hypothesis, or the
  repo's seeded stand-in, ``max_examples=10``), and the background
  realign swap equals a cold realign of the member set;
* the service's named alignments and their tree keys, the same responses
  as the reference's service;
* six HTTP threads interleaving adds, reads and trees, then a serial
  replay of the committed order;
* kill-and-resume of a spawned ``python -m repro_torch.launch.serve_msa
  --device cpu``;
* a store directory written by either package restores in the other bit
  for bit (the on-disk schema is shared).

Every spawned server and HTTP wait has a timeout, and every server is shut
down in a ``finally``.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # no hypothesis here; the repo's seeded stand-in
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core.msa import MSAConfig as JConfig
from repro.core.msa import center_star_msa as j_csm
from repro.serve import MSAService as JService
from repro.serve import ServiceConfig as JServiceConfig
from repro.serve.store import MSAStore as JStore
from repro_torch.core.alphabet import DNA
from repro_torch.core.msa import MSAConfig, center_star_msa
from repro_torch.dist.fault import StepFailure
from repro_torch.obs.metrics import REGISTRY
from repro_torch.serve import MSAService, ServiceConfig, serve_http
from repro_torch.serve.store import (COMMIT_FAULT_LABELS, MSAStore,
                                     StoreError, content_fingerprint)
from test_torch_msa_run import one_torch_thread  # noqa: F401

SRC = str(Path(__file__).resolve().parent.parent / "src")
CFG = MSAConfig(method="plain")
JCFG = JConfig(method="plain")
HTTP_TIMEOUT = 60
SPAWN_TIMEOUT = 120


def _seq(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def _sub(s, rng, k=2):
    s = list(s)
    for _ in range(k):
        s[rng.integers(0, len(s))] = "ACGT"[rng.integers(0, 4)]
    return "".join(s)


def _csm(seqs):
    return center_star_msa(seqs, CFG, device="cpu")


def _make_store(path, **kw):
    kw.setdefault("drift_threshold", 10.0)
    return MSAStore(path, device="cpu", **kw)


def _seeded(store, name="fam", n=3, L=40, seed=0):
    rng = np.random.default_rng(seed)
    base = _seq(rng, L)
    fam = [base] + [_sub(base, rng) for _ in range(n - 1)]
    res = _csm(fam)
    return store.create(name, msa=res.msa, center_idx=res.center_idx,
                        seqs=fam, names=[f"m{i}" for i in range(n)]), fam


def _entries_equal(a, b):
    return (a.generation == b.generation and a.fingerprint == b.fingerprint
            and np.array_equal(a.msa, b.msa) and a.seqs == b.seqs
            and a.names == b.names and a.center_idx == b.center_idx
            and a.base_width == b.base_width and a.width == b.width
            and a.name == b.name)


# ------------------------------------------------------------- store basics

def test_store_create_add_restart_roundtrip(tmp_path):
    store = _make_store(tmp_path / "store", keep=8)
    ref = JStore(tmp_path / "ref", keep=8, drift_threshold=10.0)
    e0, fam = _seeded(store)
    res = _csm(fam)
    ref.create("fam", msa=res.msa, center_idx=res.center_idx, seqs=fam,
               names=["m0", "m1", "m2"])
    new = [fam[0][:11] + "ACG" + fam[0][11:]]
    e1, info = store.add("fam", ["d"], new, CFG)
    w1, winfo = ref.add("fam", ["d"], new, JCFG)
    assert e1.generation == 1 and info == winfo and info["n_new"] == 1
    assert _entries_equal(e1, w1)
    assert e1.seqs == tuple(fam) + tuple(new)
    assert np.array_equal(e1.msa, _csm(fam + new).msa)
    store.close()
    ref.close()

    store2 = _make_store(tmp_path / "store")
    assert _entries_equal(store2.get("fam"), e1)
    assert store2.names() == ["fam"]
    e2, _ = store2.add("fam", ["e"], [_sub(fam[0], np.random.default_rng(1))],
                       CFG)
    assert e2.generation == 2
    store2.close()


def test_store_retention_keeps_newest_generations(tmp_path):
    store = _make_store(tmp_path / "store", keep=2)
    _, fam = _seeded(store)
    rng = np.random.default_rng(2)
    for i in range(4):
        store.add("fam", [f"x{i}"], [_sub(fam[0], rng)], CFG)
    assert store.generations("fam") == [3, 4]
    store.close()


def test_store_rejects_bad_names_and_duplicates(tmp_path):
    store = _make_store(tmp_path / "store")
    _seeded(store)
    with pytest.raises(StoreError, match="already exists"):
        _seeded(store)
    with pytest.raises(ValueError, match="invalid alignment name"):
        store.create("../evil", msa=np.zeros((1, 4), np.int8),
                     center_idx=0, seqs=["AAAA"], names=["a"])
    with pytest.raises(KeyError):
        store.get("nope")
    store.close()
    with pytest.raises(StoreError, match="already on disk"):
        _seeded(_make_store(tmp_path / "store"))


def test_corrupt_latest_generation_falls_back(tmp_path):
    store = _make_store(tmp_path / "store", keep=8)
    e0, fam = _seeded(store)
    store.add("fam", ["d"], [_sub(fam[0], np.random.default_rng(3))], CFG)
    store.close()

    p1 = tmp_path / "store" / "fam" / f"gen_{1:010d}.npz"
    p1.write_bytes(p1.read_bytes()[:100])
    with pytest.warns(UserWarning, match="unreadable"):
        r = _make_store(tmp_path / "store").get("fam")
    assert _entries_equal(r, e0)

    from repro_torch.dist.checkpoint import atomic_save_npz
    atomic_save_npz(p1, {
        "schema_version": np.int64(1), "name": np.str_("fam"),
        "msa": e0.msa, "center_idx": np.int64(e0.center_idx),
        "generation": np.int64(1), "base_width": np.int64(e0.base_width),
        "seqs": np.array(e0.seqs), "names": np.array(e0.names),
        "fingerprint": np.str_("0" * 64)})
    with pytest.warns(UserWarning, match="fingerprint mismatch"):
        r = _make_store(tmp_path / "store").get("fam")
    assert _entries_equal(r, e0)
    # the reference reads the same directory the same way
    with pytest.warns(UserWarning, match="fingerprint mismatch"):
        w = JStore(tmp_path / "store", drift_threshold=10.0).get("fam")
    assert _entries_equal(r, w)


# --------------------------------------------------- crash atomicity

class _FaultAt:
    """Raises StepFailure at the k-th hook invocation; records the label."""

    def __init__(self, fire_at):
        self.fire_at = fire_at
        self.calls = 0
        self.fired_label = None

    def __call__(self, label):
        self.calls += 1
        if self.calls == self.fire_at:
            self.fired_label = label
            raise StepFailure(f"injected at {label}")


@pytest.mark.parametrize("label", COMMIT_FAULT_LABELS)
def test_commit_crash_atomicity_at_every_label(tmp_path, label):
    """A fault at ``label`` of an add's commit, after 0, 1 or 2 clean
    adds: a restart restores the previous generation (fault before the
    atomic replace) or the new one (at or after it), never a torn state,
    and ingestion continues."""
    from repro.serve.store import COMMIT_FAULT_LABELS as J_LABELS
    assert COMMIT_FAULT_LABELS == J_LABELS
    rng = np.random.default_rng(7)
    base = _seq(rng, 32)
    fam = [base, _sub(base, rng), _sub(base, rng)]
    adds = [base[:9] + "ACG" + base[9:], _sub(base, rng),
            base[:20] + "T" + base[20:]]
    res = _csm(fam)
    fire_at = COMMIT_FAULT_LABELS.index(label) + 1
    replace_idx = COMMIT_FAULT_LABELS.index("save.post-replace")
    for pre in range(3):
        root = tmp_path / f"pre{pre}"
        store = _make_store(root, keep=8)
        store.create("fam", msa=res.msa, center_idx=res.center_idx,
                     seqs=fam, names=[f"m{i}" for i in range(3)])
        for j in range(pre):
            store.add("fam", [f"pre{j}"], [adds[j]], CFG)
        prev = store.get("fam")
        fault = _FaultAt(fire_at)
        store.fault_hook = fault
        new_seq = adds[(pre + fire_at) % len(adds)]
        with pytest.raises(StepFailure):
            store.add("fam", ["faulted"], [new_seq], CFG)
        assert fault.fired_label == label
        store.fault_hook = None
        store.close()

        restored = _make_store(root, keep=8)
        got = restored.get("fam")
        if fire_at - 1 < replace_idx:
            assert _entries_equal(got, prev), f"torn state at {label}"
        else:
            assert got.generation == prev.generation + 1
            assert got.seqs == prev.seqs + (new_seq,)
            assert got.names == prev.names + ("faulted",)
            assert content_fingerprint(got.msa, got.center_idx,
                                       got.names) == got.fingerprint
        nxt, _ = restored.add("fam", ["after"], [adds[0]], CFG)
        assert nxt.generation == got.generation + 1
        restored.close()


# --------------------------------------- incremental vs realign (property)

DNA_SEQ = st.text(alphabet="ACGT", min_size=8, max_size=40)


@settings(max_examples=10, deadline=None)
@given(st.lists(DNA_SEQ, min_size=2, max_size=4),
       st.lists(DNA_SEQ, min_size=1, max_size=3))
def test_store_adds_bit_identical_to_full_realign(seed_fam, new_seqs):
    """Every committed generation of accreted adds equals the cold full
    center-star realign of the same member set (same frozen first
    center)."""
    import tempfile
    res = _csm(seed_fam)
    with tempfile.TemporaryDirectory() as d:
        store = MSAStore(d, keep=99, drift_threshold=10.0, realign="never",
                         device="cpu")
        store.create("fam", msa=res.msa, center_idx=res.center_idx,
                     seqs=seed_fam,
                     names=[f"m{i}" for i in range(len(seed_fam))])
        members = list(seed_fam)
        for g, s in enumerate(new_seqs, start=1):
            entry, _ = store.add("fam", [f"n{g}"], [s], CFG)
            members.append(s)
            full = _csm(members)
            assert entry.generation == g
            assert entry.width == full.width
            assert np.array_equal(entry.msa, full.msa), \
                f"generation {g} diverged from the cold realign"
        store.close()


def test_background_realign_swap_is_cold_full_realign(tmp_path):
    store = _make_store(tmp_path / "store", keep=8, drift_threshold=0.2)
    _, fam = _seeded(store)
    big = fam[0][:4] + "ACGTACGTACGTACGT" + fam[0][4:]
    e1, info = store.add("fam", ["big"], [big], CFG)
    assert info["drifted"] and info["realign_pending"]
    assert store.get("fam").generation in (e1.generation,
                                           e1.generation + 1)
    store.wait_realigns(timeout=300)
    swapped = store.get("fam")
    cold = _csm(list(e1.seqs))
    assert swapped.generation == e1.generation + 1
    assert np.array_equal(swapped.msa, cold.msa)
    assert np.array_equal(swapped.msa,
                          np.asarray(j_csm(list(e1.seqs), JCFG).msa))
    assert swapped.base_width == cold.width
    assert swapped.growth() == 0.0
    store.close()
    store2 = _make_store(tmp_path / "store")
    assert _entries_equal(store2.get("fam"), swapped)
    store2.close()


# ------------------------------------------------- service + tree wiring

def test_service_named_align_add_tree_generation_keys(tmp_path):
    kw = dict(max_wait_ms=1.0, store_realign="never")
    svc = MSAService(ServiceConfig(store_dir=str(tmp_path / "store"),
                                   device="cpu", **kw))
    ref = JService(JServiceConfig(store_dir=str(tmp_path / "ref"), **kw))
    try:
        rng = np.random.default_rng(11)
        base = _seq(rng, 60)
        fam = [base, _sub(base, rng), _sub(base, rng)]
        r = svc.align_named("flu", ["a", "b", "c"], fam)
        w = ref.align_named("flu", ["a", "b", "c"], fam)
        assert r["created"] is True and r["alignment"]["generation"] == 0
        assert r["alignment"] == w["alignment"]
        fp0 = r["alignment"]["fingerprint"]
        r2 = svc.align_named("flu")
        assert r2["created"] is False
        assert r2["alignment"]["fingerprint"] == fp0
        with pytest.raises(StoreError, match="already exists"):
            svc.align_named("flu", ["x"], ["ACGTACGT"])
        t0 = svc.tree(name="flu")
        t0b = svc.tree(name="flu")
        assert t0["cached_tree"] is False and t0b["cached_tree"] is True
        assert t0["fingerprint"] == fp0
        assert t0["msa_id"] == ref.tree(name="flu")["msa_id"]
        new = _sub(base, rng)
        ra = svc.align_add(names=["d"], seqs=[new], name="flu")
        wa = ref.align_add(names=["d"], seqs=[new], name="flu")
        assert ra["alignment"] == wa["alignment"] and ra["add"] == wa["add"]
        assert ra["alignment"]["generation"] == 1
        assert ra["alignment"]["fingerprint"] != fp0
        t1 = svc.tree(name="flu")
        assert t1["cached_tree"] is False
        assert t1["fingerprint"] == ra["alignment"]["fingerprint"]
        assert t1["n_leaves"] == 4
        h = svc.healthz()
        assert h["store"] == ref.healthz()["store"]
        assert h["store"]["names"] == 1
        assert h["store"]["generations"] == {"flu": 1}
        assert "flu" in svc.statusz()
    finally:
        svc.drain()
        ref.drain()
    svc2 = MSAService(ServiceConfig(store_dir=str(tmp_path / "store"),
                                    device="cpu", **kw))
    try:
        r3 = svc2.align_named("flu")
        assert r3["alignment"] == ra["alignment"]
    finally:
        svc2.drain()


def test_service_without_store_rejects_named_requests():
    svc = MSAService(ServiceConfig(max_wait_ms=1.0, device="cpu"))
    try:
        with pytest.raises(ValueError, match="store"):
            svc.align_named("flu", ["a"], ["ACGT"])
        with pytest.raises(ValueError, match="store"):
            svc.tree(name="flu")
    finally:
        svc.drain()


# -------------------------------------------------- store across packages

def _fill(store, cfg, rng_seed=23):
    """Create "xfam" and add two members: generations 0-2."""
    rng = np.random.default_rng(rng_seed)
    base = _seq(rng, 70)
    fam = [base, _sub(base, rng), base[:30] + "GT" + base[30:]]
    res = _csm(fam)
    store.create("xfam", msa=res.msa, center_idx=res.center_idx, seqs=fam,
                 names=["a", "b", "c"])
    for i, s in enumerate((base[:12] + "T" + base[12:], _sub(base, rng))):
        store.add("xfam", [f"n{i}"], [s], cfg)
    return store.get("xfam")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_directory_restores_across_packages(tmp_path, writer):
    """A directory the reference's store wrote restores in the port's bit
    for bit (and the reverse), every generation kept; the reader adds on
    and the other package reads that back."""
    root = tmp_path / "store"
    if writer == "reference":
        w = JStore(root, keep=8, drift_threshold=10.0)
        wrote = _fill(w, JCFG)
        r = _make_store(root, keep=8)
        cfg, other = CFG, lambda: JStore(root, drift_threshold=10.0)
    else:
        w = _make_store(root, keep=8)
        wrote = _fill(w, CFG)
        r = JStore(root, keep=8, drift_threshold=10.0)
        cfg, other = JCFG, lambda: _make_store(root)
    w.close()
    got = r.get("xfam")
    assert _entries_equal(got, wrote) and got.generation == 2
    assert r.generations("xfam") == [0, 1, 2]
    nxt, _ = r.add("xfam", ["more"], [wrote.seqs[0][5:]], cfg)
    r.close()
    back = other().get("xfam")
    assert _entries_equal(back, nxt) and back.generation == 3


# ------------------------------------------------- HTTP concurrency stress

def _post(port, path, obj, timeout=HTTP_TIMEOUT):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _counter_totals(snap):
    return {fam: sum(s["value"]
                     for s in snap.get(fam, {"samples": []})["samples"])
            for fam in ("repro_requests_started_total",
                        "repro_requests_finished_total",
                        "repro_requests_rejected_total")}


def test_concurrent_http_stress_is_consistent_and_replayable(tmp_path):
    """Six threads interleave /align/add + /align + /tree on one named
    alignment through the HTTP front end: no 500s, every response
    consistent, per-thread generations monotone, counters reconcile on
    drain, and the final store equals a serial replay of the committed
    add order."""
    svc = MSAService(ServiceConfig(max_wait_ms=1.0,
                                   store_dir=str(tmp_path / "store"),
                                   store_realign="never", device="cpu"))
    httpd = serve_http(svc, "127.0.0.1", 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        before = _counter_totals(REGISTRY.snapshot())
        rng = np.random.default_rng(13)
        base = _seq(rng, 50)
        fam = [base, _sub(base, rng), _sub(base, rng)]
        st_, r = _post(port, "/align", {"name": "stress", "sequences": fam,
                                        "names": ["s0", "s1", "s2"]})
        assert st_ == 200 and r["created"]
        seed = svc.store.get("stress")
        assert seed.generation == 0
        code, err = _post(port, "/align", {"name": "stress",
                                           "sequences": fam})
        assert code == 409 and "already exists" in err["error"]

        n_threads, ops_per_thread = 6, 6
        add_seqs = {f"t{t}a{i}": _sub(base, rng)
                    for t in range(n_threads) for i in range(ops_per_thread)}
        failures, lock = [], threading.Lock()

        def worker(t):
            local_rng = np.random.default_rng(100 + t)
            last_gen = -1
            for i in range(ops_per_thread):
                op = ("add", "read", "tree")[int(local_rng.integers(0, 3))]
                try:
                    if op == "add":
                        key = f"t{t}a{i}"
                        code, resp = _post(port, "/align/add",
                                           {"name": "stress",
                                            "sequences": [add_seqs[key]],
                                            "names": [key]})
                    elif op == "read":
                        code, resp = _post(port, "/align",
                                           {"name": "stress"})
                    else:
                        code, resp = _post(port, "/tree", {"name": "stress"})
                    assert code == 200, f"{op} -> {code}: {resp}"
                    if op == "tree":
                        assert resp["newick"].endswith(";")
                        gen = resp["generation"]
                    else:
                        aln = resp["alignment"]
                        gen = aln["generation"]
                        assert all(len(row) == aln["width"]
                                   for row in aln["rows"])
                        assert len(aln["rows"]) == len(aln["names"])
                    assert gen >= last_gen, "generation went backwards"
                    last_gen = gen
                except Exception as e:                # noqa: BLE001
                    with lock:
                        failures.append(f"thread {t} op {i} ({op}): {e!r}")

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        assert not failures, failures
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.drain()

    after = _counter_totals(REGISTRY.snapshot())
    d = {k: after[k] - before[k] for k in after}
    assert d["repro_requests_started_total"] == \
        d["repro_requests_finished_total"] + d["repro_requests_rejected_total"]

    final = svc.store.get("stress")
    assert final.names[:len(seed.names)] == seed.names
    committed = list(final.names[len(seed.names):])
    replay = _make_store(tmp_path / "replay", keep=4, realign="never")
    replay.create("stress", msa=seed.msa, center_idx=seed.center_idx,
                  seqs=seed.seqs, names=seed.names)
    for key in committed:
        replay.add("stress", [key], [add_seqs[key]], CFG)
    replayed = replay.get("stress")
    assert replayed.generation == final.generation
    assert np.array_equal(replayed.msa, final.msa)
    assert replayed.fingerprint == final.fingerprint
    replay.close()


# --------------------------------------------------- kill-and-resume (e2e)

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_server(store_dir):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_msa",
         "--device", "cpu", "--port", str(port), "--max-wait-ms", "1",
         "--store-dir", str(store_dir), "--store-realign", "never"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    deadline = time.time() + SPAWN_TIMEOUT
    while True:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                json.loads(r.read())
            return proc, port
        except (urllib.error.URLError, OSError):
            if proc.poll() is not None:
                out = proc.stdout.read().decode(errors="replace")
                raise RuntimeError(f"serve_msa died at startup:\n{out}")
            if time.time() > deadline:
                proc.kill()
                proc.wait()
                raise RuntimeError("serve_msa did not become healthy")
            time.sleep(0.3)


def _stop(proc, sig=signal.SIGKILL):
    if proc.poll() is None:
        proc.send_signal(sig)
    try:
        return proc.wait(timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait()


def _rows_fingerprint(aln):
    msa = np.stack([DNA.encode_aligned(row) for row in aln["rows"]])
    return content_fingerprint(msa, aln["center_idx"], aln["names"])


def test_kill_and_resume_restores_committed_state(tmp_path):
    """SIGKILL a spawned serving worker (idle, then mid-traffic); each
    restart from the same --store-dir restores the last committed
    generation bit-identically and ingestion continues; SIGTERM drains
    with exit code 0."""
    store_dir = tmp_path / "store"
    rng = np.random.default_rng(17)
    base = _seq(rng, 48)
    fam = [base, _sub(base, rng), _sub(base, rng)]

    proc, port = _spawn_server(store_dir)
    try:
        st_, r = _post(port, "/align", {"name": "cov", "sequences": fam,
                                        "names": ["a", "b", "c"]})
        assert st_ == 200
        for i in range(3):
            st_, r = _post(port, "/align/add",
                           {"name": "cov", "sequences": [_sub(base, rng)],
                            "names": [f"d{i}"]})
            assert st_ == 200
        committed = r["alignment"]
        assert committed["generation"] == 3
        assert _rows_fingerprint(committed) == committed["fingerprint"]
    finally:
        _stop(proc)

    proc, port = _spawn_server(store_dir)
    killed_mid_traffic = []
    try:
        st_, r = _post(port, "/align", {"name": "cov"})
        assert st_ == 200
        aln = r["alignment"]
        for k in ("generation", "fingerprint", "rows", "names"):
            assert aln[k] == committed[k], k
        stop = threading.Event()

        def traffic():
            i = 0
            while not stop.is_set() and i < 50:
                try:
                    code, resp = _post(port, "/align/add",
                                       {"name": "cov",
                                        "sequences": [_sub(base, rng)],
                                        "names": [f"k{i}"]}, timeout=10)
                    if code == 200:
                        killed_mid_traffic.append(resp["alignment"])
                except Exception:              # noqa: BLE001
                    return                     # server died under us
                i += 1

        t = threading.Thread(target=traffic)
        t.start()
        time.sleep(0.4)
        proc.send_signal(signal.SIGKILL)
        stop.set()
        t.join(timeout=60)
    finally:
        _stop(proc)

    proc, port = _spawn_server(store_dir)
    try:
        st_, r = _post(port, "/align", {"name": "cov"})
        assert st_ == 200
        aln = r["alignment"]
        assert _rows_fingerprint(aln) == aln["fingerprint"]
        acked = killed_mid_traffic[-1] if killed_mid_traffic else committed
        assert aln["generation"] >= acked["generation"]
        if aln["generation"] == acked["generation"]:
            assert aln["fingerprint"] == acked["fingerprint"]
            assert aln["rows"] == acked["rows"]
        else:
            n = len(acked["names"])
            assert aln["names"][:n] == acked["names"]
        st_, r2 = _post(port, "/align/add",
                        {"name": "cov", "sequences": [_sub(base, rng)],
                         "names": ["resumed"]})
        assert st_ == 200
        assert r2["alignment"]["generation"] == aln["generation"] + 1
        st_, t2 = _post(port, "/tree", {"name": "cov"})
        assert st_ == 200 and t2["newick"].endswith(";")
        assert t2["fingerprint"] == r2["alignment"]["fingerprint"]
        assert _stop(proc, signal.SIGTERM) == 0
        out = proc.stdout.read().decode(errors="replace")
        assert "drained; bye" in out, out
    finally:
        _stop(proc)
    # the reference's store reads what the port's server committed
    got = JStore(store_dir, drift_threshold=10.0).get("cov")
    assert got.fingerprint == r2["alignment"]["fingerprint"]
