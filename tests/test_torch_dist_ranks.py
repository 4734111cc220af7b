"""The port's distributed runtime in spawned ``gloo`` worlds of 2, 3 and 8
ranks (``repro_torch.dist``), on the CPU.

Each world is spawned once per module (a ``FileStore`` under ``tmp_path``,
no ports, at most ``WORLD_TIMEOUT`` seconds) and runs every job of its
list; each rank saves what it computed, and each check below is a test of
its own. Every rank must hold the same result, and that result must be:

* the MSA rows: byte for byte the reference host's (``repro.core.msa.
  center_star_msa``) and, for ``distributed_center_star`` on a 4x2 mesh,
  the reference's own mesh pipeline on its one CPU device;
* strips, ``nearest_assign``, tiled trees, bootstrap replicate trees, the
  search fleet and seed counts: bitwise the port's one-process results
  (strips also within rtol 1e-5 / atol 1e-6 of the reference's);
* the launchers (``msa_run --dist``, ``search_run --dist``, ``tree_run
  --mesh 2x1``): files equal to the same runs in one process;
* the collectives at 2, 4 and 8 ranks: the reference's one-device
  ``shard_map`` results on the concatenated inputs (``ring_all_gather``
  exactly, ``ag_matmul_overlap`` within rtol 1e-5), each rank's chunk of
  the mean for ``psum_scatter_mean`` (rtol 1e-5), and the compressed mean
  within 1.01 x its scale of the true mean, its error feedback
  ``v - q * scale`` within 1e-6;
* a rank that fails fails its world.

The children import the port only (no JAX); the references run here.
"""
import json
import os
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = str(Path(__file__).resolve().parents[1] / "src")
WORLD_TIMEOUT = 120
GAP, NCH = 5, 5


# ---------------------------------------------------------------- inputs

def _mut_family(seed, n, L, nsub=3):
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), L))

    def mut(s):
        s = list(s)
        for _ in range(nsub):
            i = rng.integers(0, len(s))
            s[i] = "ACGT"[rng.integers(0, 4)]
        return "".join(s)
    return base, [mut(base) for _ in range(n)]


def _msa_seqs(n_queries, seed=7, L=80):
    base, seqs = _mut_family(seed, n_queries, L)
    return [base] + seqs


def _sim(n, L, seed, **kw):
    from repro_torch.data import SimConfig, simulate_family
    return simulate_family(SimConfig(n_leaves=n, root_len=L, seed=seed,
                                     **kw))


def _aligned(n, L=120, seed=2):
    """Equal-length rows of a substitution-only family (already aligned)."""
    from repro_torch.core import alphabet as ab
    fam = _sim(n, L, seed, branch_sub=0.03, branch_indel=0.0)
    return np.asarray(ab.encode_batch(fam.seqs, ab.DNA)[0])


def _fleet_msa():
    from repro_torch.core.msa import MSAConfig, center_star_msa
    fam = _sim(8, 120, 1)
    return np.asarray(center_star_msa(fam.seqs, MSAConfig(method="kmer"),
                                      device="cpu").msa)


def _search_db():
    rng = np.random.default_rng(0)

    def rseq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    def mut(s, p=0.06):
        return "".join("ACGT"[rng.integers(0, 4)] if rng.random() < p else x
                       for x in s)
    base = rseq(120)
    names = [f"m{j}" for j in range(5)] + [f"decoy{j}" for j in range(4)]
    seqs = [mut(base) for _ in range(5)] + [rseq(120) for _ in range(4)]
    return names, seqs, ["q", "rnd", "tiny"], [mut(base), rseq(90), "ACG"]


def _coll_inputs(rank, n):
    g = np.random.default_rng(100 + rank)
    return dict(x=g.standard_normal((3, 5)).astype(np.float32),
                a=np.random.default_rng(50).standard_normal(
                    (4, 6)).astype(np.float32),
                w=g.standard_normal((6, 3)).astype(np.float32),
                s=g.standard_normal((2 * n, 3)).astype(np.float32),
                v=(g.standard_normal((7,)) * 3).astype(np.float32),
                e=(g.standard_normal((7,)) * 0.01).astype(np.float32))


MSA_CFG = dict(method="kmer", k=8, max_anchors=64, max_seg=48)
TREE_KW = dict(gap_code=GAP, n_chars=NCH, backend="tiled", row_block=16,
               target_cluster=8, device="cpu")
FLEET_KW = dict(gap_code=GAP, starts=3, spr_radius=2, rounds=2,
                model="jc69", steps=10, seed=0, device="cpu")
N_BOOT = 7


# ------------------------------------------------------ jobs of the ranks

def job_msa(mesh):
    """msa_over_mesh on 5 (2 ranks: kmer and plain), 7 (3 ranks) or 15
    (8 ranks) queries."""
    from repro_torch.core.msa import MSAConfig
    from repro_torch.dist import mapreduce
    n_q = {2: 5, 3: 7, 8: 15}[mesh.size]
    seqs = _msa_seqs(n_q)
    return {m: mapreduce.msa_over_mesh(
        seqs, MSAConfig(**dict(MSA_CFG, method=m)), mesh).msa
        for m in (("kmer", "plain") if mesh.size == 2 else ("kmer",))}


def job_dcs(mesh):
    """distributed_center_star on 16 queries against a separate center
    (the reference's 8-device case), rows gathered over the data axis."""
    from repro_torch.core import alphabet as ab
    from repro_torch.core import kmer_index
    from repro_torch.dist import mapreduce, sharding as sh
    base, seqs = _mut_family(0, 16, 256, nsub=4)
    S, lens = ab.encode_batch(seqs, ab.DNA)
    center = torch.from_numpy(ab.DNA.encode(base))
    table = kmer_index.build_center_index(center, len(base), k=8)
    fn = mapreduce.distributed_center_star(
        mesh, method="kmer", sub=ab.dna_matrix(), gap_code=GAP, out_len=300,
        num_slots=len(base) + 1, gap_open=3, gap_extend=1, k=8,
        max_anchors=64, max_seg=48)
    rows, G = fn(sh.shard_rows(S, mesh), sh.shard_rows(lens, mesh),
                 sh.broadcast(center, mesh), len(base),
                 sh.broadcast(table, mesh))
    return {"rows": sh.gather_rows(rows, mesh).numpy(), "G": G.numpy()}


def job_tiles(mesh):
    """Strips of the whole matrix and the nearest-anchor assignment."""
    from repro_torch.phylo import TileContext
    msa = np.random.default_rng(3).integers(0, GAP + 1, (37, 50)).astype(
        np.int8)
    ctx = TileContext(gap_code=GAP, n_chars=NCH, row_block=8, mesh=mesh,
                      device="cpu")
    strips = np.concatenate([s for _, _, s in ctx.strips(msa)])
    assign, own = ctx.nearest_assign(msa, msa[[0, 9, 30]])
    return {"strips": strips, "assign": assign, "own": own}


def job_tree(mesh):
    """TreeEngine(backend='tiled') over the mesh."""
    from repro_torch.phylo import TreeEngine
    res = TreeEngine(mesh=mesh, **TREE_KW).build(_aligned(40))
    return {"newick": res.newick(), "backend": res.backend,
            "children": res.children, "blen": res.blen}


def job_boot(mesh):
    """N_BOOT bootstrap replicate trees split over the data axis."""
    from repro_torch.core import likelihood as lik
    from repro_torch.phylo.ml import MLRefiner
    patterns, weights = lik.compress_patterns(_aligned(12, L=90, seed=4))
    ch, bl = MLRefiner(gap_code=GAP, seed=5, mesh=mesh,
                       device="cpu").replicate_trees(
        torch.from_numpy(np.asarray(patterns)), np.asarray(weights), N_BOOT)
    return {"children": ch, "blen": bl}


def job_fleet(mesh):
    """A K = 3 search fleet with its candidate scoring split."""
    from repro_torch.phylo.treesearch import TreeSearcher
    res = TreeSearcher(mesh=mesh, **FLEET_KW).search(_fleet_msa())
    return {"children": res.children, "blen": res.blen,
            "traj": res.trajectories, "logl": res.logl_final}


def job_seed(mesh):
    """The search seed stage with the DB's tables split."""
    from repro_torch.search import SearchConfig, SearchEngine
    names, seqs, _, qseqs = _search_db()
    eng = SearchEngine(SearchConfig(), mesh=mesh, device="cpu")
    index = eng.build_index(names, seqs)
    Q, qlens = eng._encode_queries(qseqs)
    return {"counts": eng.seed_counts(Q, qlens, index)}


def job_launchers(mesh):
    """msa_run --dist --tree tiled, search_run --dist and tree_run --mesh
    (ML + bootstrap, and the search fleet); rank 0 writes under
    ``$DIST_OUT``."""
    from repro_torch.launch import msa_run, search_run, tree_run
    out = Path(os.environ["DIST_OUT"])
    mesh_arg = f"{mesh.size}x1"
    if mesh.rank == 0:
        _launcher_inputs(out)
    mesh.barrier()
    msa_run.main(_msa_argv(out, "msa") + ["--dist"])
    search_run.main(_search_argv(out, "search") + ["--dist"])
    for name, flags in _TREE_RUNS.items():
        tree_run.main(_tree_argv(out, name, flags) + ["--mesh", mesh_arg])
    return {}


def _msa_argv(out: Path, name: str):
    return ["--fasta", str(out / "fam.fa"), "--out", str(out / name),
            "--device", "cpu", "--tree", "tiled", "--k", "8"]


def _search_argv(out: Path, name: str):
    return ["--db", str(out / "db.fa"), "--query", str(out / "q.fa"),
            "--out", str(out / name), "--device", "cpu", "--score",
            "global", "--backend", "banded-pallas", "--max-evalue", "1e-6"]


def _tree_argv(out: Path, name: str, flags):
    return ["--fasta", str(out / "aligned.fa"), "--out", str(out / name),
            "--device", "cpu", *flags]


_TREE_RUNS = {
    "tree_ml": ["--refine", "ml", "--bootstrap", str(N_BOOT), "--ml-steps",
                "10", "--nni-rounds", "2"],
    "tree_search": ["--refine", "search", "--starts", "3", "--ml-steps",
                    "5", "--search-rounds", "1", "--restartable"]}


def _launcher_inputs(out: Path):
    from repro_torch.core import alphabet as ab
    from repro_torch.data import write_fasta
    out.mkdir(parents=True, exist_ok=True)
    fam = _sim(20, 150, 6)
    write_fasta(out / "fam.fa", fam.names, fam.seqs)
    names, seqs, qn, qs = _search_db()
    write_fasta(out / "db.fa", names, seqs)
    write_fasta(out / "q.fa", qn[:1], qs[:1])
    rows = _aligned(10, L=100, seed=8)
    write_fasta(out / "aligned.fa", [f"s{i}" for i in range(len(rows))],
                [ab.DNA.decode(r) for r in rows])


def job_coll(mesh):
    """Collectives over the world, and on 8 ranks over two groups of 4."""
    from repro_torch.dist import collectives as col
    from repro_torch.dist import grad_compression as gc
    out = {}
    groups = [(None, mesh.size, mesh.rank)]
    if mesh.size == 8:
        halves = [dist.new_group([0, 1, 2, 3]), dist.new_group([4, 5, 6, 7])]
        groups.append((halves[mesh.rank // 4], 4, mesh.rank % 4))
    for group, n, r in groups:
        t = {k: torch.from_numpy(v) for k, v in _coll_inputs(r, n).items()}
        mean, ef = gc.compressed_psum_mean(t["v"], group, t["e"])
        prev = gc._GATHER_MAX
        gc._GATHER_MAX = 1                  # the int32 SUM route
        try:
            mean_sum, _ = gc.tree_compressed_psum_mean(
                {"v": [t["v"]]}, group, {"v": [t["e"]]})
        finally:
            gc._GATHER_MAX = prev
        out[n] = {"gather": col.ring_all_gather(t["x"], group).numpy(),
                  "agmm": col.ag_matmul_overlap(t["a"], t["w"],
                                                group).numpy(),
                  "scatter": col.psum_scatter_mean(t["s"], group).numpy(),
                  "mean": mean.numpy(), "ef": ef.numpy(),
                  "mean_sum": mean_sum["v"][0].numpy()}
    return out


def job_fail(mesh):
    """Rank 1 fails while rank 0 waits for it at a barrier."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    mesh.barrier()
    return {}


SERVE_THRESHOLD = 10     # families of >= this many go over the mesh


def _serve_inputs():
    """A family over the threshold, one under it, a second big family
    and the search database, from numpy seeds."""
    fam = _sim(14, 150, 11)
    fam2 = _sim(12, 140, 12)
    small = _mut_family(13, 5, 90)[1]
    return fam, fam2, small, _search_db()


def _serve_config(mesh, index, config=None, **kw):
    """The mesh service's configuration (the port's unless ``config``)."""
    if config is None:
        from repro_torch.serve import ServiceConfig as config
        kw["device"] = "cpu"
    return config(max_wait_ms=1.0, dist_threshold=SERVE_THRESHOLD,
                  search_index=index, mesh=mesh, **kw)


def _strip(resp: dict) -> dict:
    """A response without what varies from run to run."""
    return {k: v for k, v in resp.items()
            if k not in ("elapsed_ms", "trace_id", "cache")}


def _serve_requests(svc, ml: bool = True) -> dict:
    """rank 0's requests to a mesh service: /align over and under the
    threshold, /tree tiled (twice: the second a cache hit) and ML with
    bootstrap, /search, then a big /align and a /search at once from two
    threads (both mesh jobs). Returns the responses, stripped."""
    import threading
    fam, fam2, small, (names, seqs, qn, qs) = _serve_inputs()
    out = {"align": svc.align(fam.names, fam.seqs),
           "align_small": svc.align([f"s{i}" for i in range(len(small))],
                                    small)}
    mid = out["align"]["alignment"]["msa_id"]
    out["tree"] = svc.tree(msa_id=mid, backend="tiled")
    out["tree_again"] = svc.tree(msa_id=mid, backend="tiled")
    if ml:
        out["tree_ml"] = svc.tree(msa_id=mid, refine="ml", model="jc69",
                                  bootstrap=2)
    out["search"] = svc.search(qn, qs)
    both = {}
    threads = [threading.Thread(target=lambda: both.update(
        align2=svc.align(fam2.names, fam2.seqs))),
        threading.Thread(target=lambda: both.update(
            search2=svc.search(qn[:1], qs[:1], max_hits=3)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WORLD_TIMEOUT)
    assert set(both) == {"align2", "search2"}, "concurrent mesh requests"
    out.update(both)
    return {k: _strip(v) for k, v in out.items()}


def job_serve(mesh):
    """The service over the mesh: rank 0 runs ``_serve_requests`` and
    drains (which stops the followers); the other ranks follow. Rank 0
    idles first past a short heartbeat, so no-op jobs come between the
    real ones."""
    from repro_torch.search import SearchIndex
    from repro_torch.serve import MSAService, service
    names, seqs, _, _ = _search_db()
    index = SearchIndex.build(names, seqs, device="cpu")
    service.HEARTBEAT_S = 0.1       # the followers see no-op jobs too
    svc = MSAService(_serve_config(mesh, index))
    if mesh.rank != 0:
        try:
            return {"followed": svc.follow()}
        finally:
            svc.drain()
    try:
        time.sleep(0.5)
        out = _serve_requests(svc)
        out["mesh_jobs"] = svc._mesh.n_jobs
    finally:
        svc.drain()
    return out


def _post(url: str, payload: dict):
    """POST ``payload`` as JSON; returns (status, body, seconds)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    t0 = time.time()
    try:
        with urllib.request.urlopen(req, timeout=WORLD_TIMEOUT) as r:
            status, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    return status, body, time.time() - t0


def job_serve_fault(mesh):
    """The mesh service over HTTP with errors planted in its ``msa`` job:
    the first call raises ``ValueError`` on every rank (an error of the
    data), the third a ``RuntimeError`` on rank 1 only, half a second in,
    while rank 0 waits for it in the job's collectives. Rank 0 posts a
    big family four times (the error, the same family, a second one for
    the fault, the second again) and then a small one."""
    import threading
    from repro_torch.serve import MSAService, serve_http
    fam, fam2, small, _ = _serve_inputs()
    svc = MSAService(_serve_config(mesh, None))
    real, calls = svc._mesh.handlers["msa"], []

    def planted(canon):
        calls.append(len(canon))
        if len(calls) == 1:
            raise ValueError("planted: an error of the data")
        if len(calls) == 3 and mesh.rank == 1:
            time.sleep(0.5)
            raise RuntimeError("planted: a fault on rank 1")
        return real(canon)
    svc._mesh.handlers["msa"] = planted
    if mesh.rank != 0:
        try:
            svc.follow()
        except RuntimeError as e:
            return {"raised": str(e), "calls": len(calls)}
        finally:
            svc.drain()
        return {"raised": None, "calls": len(calls)}
    httpd = serve_http(svc, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/align"
    out = {}
    try:
        for key, f in (("data", fam), ("ok", fam), ("fault", fam2),
                       ("after", fam2)):
            out[key] = _post(url, {"names": f.names, "sequences": f.seqs})
        out["small"] = _post(url, {"sequences": small})
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.drain()
    out["calls"] = len(calls)
    return out


JOBS = {f.__name__[4:]: f for f in (job_msa, job_dcs, job_tiles, job_tree,
                                    job_boot, job_fleet, job_seed,
                                    job_launchers, job_coll, job_fail,
                                    job_serve, job_serve_fault)}


# ------------------------------------------------------------- the worlds

def _child(rank, n, shape, jobs, tmp):
    sys.path.insert(0, SRC)
    torch.set_num_threads(1)
    os.environ["DIST_OUT"] = os.path.join(tmp, "launch")
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), n),
        rank=rank, world_size=n, timeout=timedelta(seconds=WORLD_TIMEOUT))
    try:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(shape, device="cpu")
        out = {name: JOBS[name](mesh) for name in jobs}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():       # a fault job leaves it itself
            dist.destroy_process_group()


def _spawn(tmp: Path, shape, jobs):
    """Run ``jobs`` on a world of prod(shape) ranks; returns each rank's
    results. A rank's failure, or a world past ``WORLD_TIMEOUT``, fails."""
    n = int(np.prod(shape))
    ctx = mp.start_processes(_child, args=(n, tuple(shape), tuple(jobs),
                                           str(tmp)),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.time() + WORLD_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.time() > deadline:
                raise TimeoutError(f"world {shape} ran past "
                                   f"{WORLD_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    return tmp, _spawn(tmp, (2, 1), ["msa", "tiles", "tree", "boot",
                                     "fleet", "seed", "coll", "launchers"])


@pytest.fixture(scope="module")
def serve_world2(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("serve2"), (2, 1), ["serve"])


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world3"), (3, 1), ["msa"])


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world8"), (4, 2),
                  ["msa", "dcs", "coll"])


def _same_on_every_rank(ranks, job):
    first = ranks[0][job]
    for r in ranks[1:]:
        _assert_equal(r[job], first)
    return first


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b



def test_a_rank_failure_fails_the_world(tmp_path):
    """A rank that raises fails its world, and the rank waiting for it
    does not hang it: its collective raises too (whichever rank's error
    the parent reads first)."""
    t0 = time.time()
    with pytest.raises(mp.ProcessRaisedException,
                       match="rank 1 fails|Connection"):
        _spawn(tmp_path, (2, 1), ["fail"])
    assert time.time() - t0 < WORLD_TIMEOUT


# ------------------------------------------------------------------ MSA

def _reference_host(seqs, method):
    from repro.core.msa import MSAConfig as JConfig
    from repro.core.msa import center_star_msa as j_csm
    return np.asarray(j_csm(seqs, JConfig(**dict(MSA_CFG,
                                                 method=method))).msa)


@pytest.mark.parametrize("world,n_q", [("world2", 5), ("world3", 7),
                                       ("world8", 15)])
def test_msa_over_ranks_equals_reference_host(world, n_q, request):
    """5 queries over 2 ranks (padded to 6), 7 over 3 and 15 over a 4x2
    mesh (16 rows, no padding): byte for byte the reference host's rows
    (kmer; on 2 ranks plain too)."""
    ranks = request.getfixturevalue(world)
    ranks = ranks[1] if world == "world2" else ranks
    got = _same_on_every_rank(ranks, "msa")
    seqs = _msa_seqs(n_q)
    assert set(got) == ({"kmer", "plain"} if world == "world2"
                        else {"kmer"})
    for method in got:
        ref = _reference_host(seqs, method)
        assert got[method].shape == ref.shape
        assert got[method].tobytes() == ref.tobytes(), method


def test_center_star_4x2_equals_reference_mesh(world8):
    """``distributed_center_star`` on a 4x2 mesh (16 queries, the
    reference's 8-device case) against the reference's pipeline on its
    one device: rows and merged profile equal."""
    import jax.numpy as jnp
    from repro.core import alphabet as jab
    from repro.core import kmer_index as jki
    from repro.dist import mapreduce as jmr
    from repro.dist import sharding as jsh
    from repro.launch.mesh import make_local_mesh as jmesh
    got = _same_on_every_rank(world8, "dcs")
    base, seqs = _mut_family(0, 16, 256, nsub=4)
    S, lens = jab.encode_batch(seqs, jab.DNA)
    center = jnp.asarray(jab.DNA.encode(base))
    lc = jnp.int32(len(base))
    mesh = jmesh((1, 1))
    fn = jmr.distributed_center_star(
        mesh, method="kmer", sub=jab.dna_matrix().astype(jnp.float32),
        gap_code=GAP, out_len=300, num_slots=len(base) + 1, gap_open=3,
        gap_extend=1, k=8, max_anchors=64, max_seg=48)
    rows, G = fn(jsh.shard_rows(S, mesh), jsh.shard_rows(lens, mesh),
                 jsh.broadcast(center, mesh), lc,
                 jsh.broadcast(jki.build_center_index(center, lc, k=8),
                               mesh))
    assert got["rows"].tobytes() == np.asarray(rows).tobytes()
    np.testing.assert_array_equal(got["G"], np.asarray(G))
    assert all(jab.DNA.decode(r).replace("-", "") == s
               for s, r in zip(seqs, got["rows"]))


# ----------------------------------------------------------- tree stages

def test_strips_and_assignment_over_two_ranks(world2):
    """Strips and ``nearest_assign`` over 2 ranks: bitwise the port's one
    process, and within rtol 1e-5 / atol 1e-6 of the reference's."""
    from repro.phylo.tiles import TileContext as JTileContext
    from repro_torch.phylo import TileContext
    got = _same_on_every_rank(world2[1], "tiles")
    msa = np.random.default_rng(3).integers(0, GAP + 1, (37, 50)).astype(
        np.int8)
    anchors = msa[[0, 9, 30]]
    one = TileContext(gap_code=GAP, n_chars=NCH, row_block=8, device="cpu")
    strips = np.concatenate([s for _, _, s in one.strips(msa)])
    assign, own = one.nearest_assign(msa, anchors)
    assert got["strips"].tobytes() == strips.tobytes()
    assert got["assign"].tobytes() == assign.tobytes()
    assert got["own"].tobytes() == own.tobytes()
    ref = JTileContext(gap_code=GAP, n_chars=NCH, row_block=8)
    ref_strips = np.concatenate([s for _, _, s in ref.strips(msa)])
    np.testing.assert_allclose(got["strips"], ref_strips, rtol=1e-5,
                               atol=1e-6)
    ref_near = ref.nearest(msa, anchors)
    np.testing.assert_array_equal(got["assign"], ref_near.argmin(axis=1))
    np.testing.assert_allclose(got["own"], ref_near.min(axis=1), rtol=1e-5,
                               atol=1e-6)


def test_tiled_tree_over_two_ranks(world2):
    from repro_torch.phylo import TreeEngine
    got = _same_on_every_rank(world2[1], "tree")
    one = TreeEngine(**TREE_KW).build(_aligned(40))
    assert got["backend"] == one.backend == "tiled"
    assert got["newick"] == one.newick()
    assert got["children"].tobytes() == one.children.tobytes()
    assert got["blen"].tobytes() == one.blen.tobytes()


def test_bootstrap_replicates_over_two_ranks(world2):
    """B = 7 over 2 ranks (4 + 3 and a zero-weight pad): each replicate
    tree bitwise the one-process batch's."""
    from repro_torch.core import likelihood as lik
    from repro_torch.phylo.ml import MLRefiner
    got = _same_on_every_rank(world2[1], "boot")
    patterns, weights = lik.compress_patterns(_aligned(12, L=90, seed=4))
    ch, bl = MLRefiner(gap_code=GAP, seed=5, device="cpu").replicate_trees(
        torch.from_numpy(np.asarray(patterns)), np.asarray(weights), N_BOOT)
    assert got["children"].shape == (N_BOOT, 23, 2)
    assert got["children"].tobytes() == ch.tobytes()
    assert got["blen"].tobytes() == bl.tobytes()


def test_search_fleet_over_two_ranks(world2):
    """K = 3 searches scored over 2 ranks (padded to 4): trajectories,
    best tree and logL bitwise the one-process fleet's."""
    from repro_torch.phylo.treesearch import TreeSearcher
    got = _same_on_every_rank(world2[1], "fleet")
    one = TreeSearcher(**FLEET_KW).search(_fleet_msa())
    assert np.array_equal(got["traj"], one.trajectories, equal_nan=True)
    assert got["traj"].tobytes() == one.trajectories.tobytes()
    assert got["children"].tobytes() == one.children.tobytes()
    assert got["blen"].tobytes() == one.blen.tobytes()
    assert got["logl"] == one.logl_final


def test_seed_counts_over_two_ranks(world2):
    """The DB's 9 tables over 2 ranks (padded to 10): the reference's
    ``seed_counts_batch`` counts."""
    import jax.numpy as jnp
    from repro.search import SearchConfig as JConfig
    from repro.search import SearchEngine as JEngine
    from repro.search import seed_counts_batch as j_seed_counts
    got = _same_on_every_rank(world2[1], "seed")["counts"]
    names, seqs, _, qseqs = _search_db()
    jeng = JEngine(JConfig())
    jidx = jeng.build_index(names, seqs)
    Q, qlens = (np.asarray(x) for x in jeng._encode_queries(qseqs))
    ref = j_seed_counts(jnp.asarray(Q), jnp.asarray(qlens, jnp.int32),
                        jnp.asarray(jidx.lens), jnp.asarray(jidx.tables),
                        k=jidx.k, stride=1, max_anchors=32,
                        max_seg=1 << 20)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got.shape == (3, 9) and got[0].min() > 0


# ------------------------------------------------------------ launchers

@pytest.fixture(scope="module")
def one_process_runs(world2):
    """The launchers' same runs in this process: msa_run and search_run
    without --dist, tree_run without --mesh."""
    from repro_torch.launch import msa_run, search_run, tree_run
    out = world2[0] / "launch"
    msa_run.main(_msa_argv(out, "msa_one"))
    search_run.main(_search_argv(out, "search_one"))
    for name, flags in _TREE_RUNS.items():
        tree_run.main(_tree_argv(out, f"{name}_one", flags))
    return out


@pytest.mark.parametrize("name,files", [
    ("msa", ("aligned.fasta", "tree.nwk")), ("search", ("hits.json",)),
    ("tree_ml", ("tree.nwk",)), ("tree_search", ("tree.nwk",))])
def test_launchers_over_two_ranks(one_process_runs, name, files):
    """``msa_run --dist --tree tiled``, ``search_run --dist`` and
    ``tree_run --mesh 2x1`` (ML + 7 bootstrap replicates; the restartable
    fleet, its checkpoints written by rank 0) write what one process
    writes; under --dist the report's ``kmer_fallbacks`` is null and the
    hits' ``seed`` stat says mesh."""
    out = one_process_runs
    dist_dir, one_dir = out / name, out / f"{name}_one"
    for f in files:
        a, b = (dist_dir / f).read_bytes(), (one_dir / f).read_bytes()
        if f == "hits.json":
            a, b = json.loads(a), json.loads(b)
            assert a["stats"].pop("seed") == "mesh"
            assert b["stats"].pop("seed") == "host"
        assert a == b, f
    if name == "msa":
        rep = json.loads((dist_dir / "report.json").read_text())
        assert rep["kmer_fallbacks"] is None
        assert json.loads((one_dir / "report.json").read_text())[
            "kmer_fallbacks"] >= 0
    if name == "tree_search":
        steps = sorted(p.name for p in (dist_dir / "search_ckpt").iterdir())
        assert steps == sorted(p.name for p in
                               (one_dir / "search_ckpt").iterdir())
        assert steps


# ---------------------------------------------------------- collectives

def _ref_collective(f, *args):
    """``f(*args, "data")`` under the reference's shard_map on its one
    device, every operand replicated."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.dist.sharding import shard_map
    from repro.launch.mesh import make_local_mesh as jmesh
    fn = shard_map(lambda *a: f(*a, "data"), jmesh((1, 1)),
                   in_specs=tuple(P() for _ in args), out_specs=P(),
                   check_vma=False)
    return np.asarray(fn(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_collectives_over_ranks(world2, world8, n):
    """At 2 ranks, and at 4 (two groups of the 8-rank world) and 8: the
    ring gather and the matmul ring equal the reference's one-device
    results on the concatenated inputs; the reduce-scatter mean is each
    rank's chunk of the mean; the compressed mean (int8 gather and int32
    SUM routes) is within 1.01 x scale of the true mean, its error
    feedback v - q * scale."""
    from repro.dist import collectives as jcol
    ranks = world2[1] if n == 2 else world8
    members = range(n) if n != 4 else range(4)
    res = [ranks[r]["coll"][n] for r in members]
    ins = [_coll_inputs(r, n) for r in range(n)]
    x = np.concatenate([i["x"] for i in ins])
    w = np.concatenate([i["w"] for i in ins], axis=1)
    ref_gather = _ref_collective(jcol.ring_all_gather, x)
    ref_agmm = _ref_collective(jcol.ag_matmul_overlap, ins[0]["a"], w)
    mean_s = np.mean([i["s"] for i in ins], axis=0)
    v = np.stack([i["v"] + i["e"] for i in ins])
    scale = np.float32(np.abs(v).max() / 127.0)
    for r, got in enumerate(res):
        assert got["gather"].tobytes() == ref_gather.tobytes()
        np.testing.assert_allclose(got["agmm"], ref_agmm, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["scatter"], mean_s[2 * r:2 * r + 2],
                                   rtol=1e-5, atol=1e-6)
        for key in ("mean", "mean_sum"):
            assert np.abs(got[key] - v.mean(axis=0)).max() <= 1.01 * scale
        q = np.clip(np.round(v[r] / scale), -127, 127)
        np.testing.assert_allclose(got["ef"], v[r] - q * scale, atol=1e-6)
        assert got["mean"].tobytes() == res[0]["mean"].tobytes()
        assert got["mean"].tobytes() == got["mean_sum"].tobytes()
    if n == 4:       # the other group of 4 saw the same inputs
        for r in range(4, 8):
            _assert_equal(world8[r]["coll"][4], res[r - 4])


# -------------------------------------------------------------- service

@pytest.fixture(scope="module")
def serve_world1():
    """The mesh service in a world of one, in this process."""
    from repro_torch.launch import mesh as lm
    from repro_torch.search import SearchIndex
    from repro_torch.serve import MSAService
    names, seqs, _, _ = _search_db()
    index = SearchIndex.build(names, seqs, device="cpu")
    with lm.world("cpu"):
        svc = MSAService(_serve_config(lm.mesh_from_arg(None, device="cpu"),
                                       index))
        try:
            out = _serve_requests(svc)
            out["mesh_jobs"] = svc._mesh.n_jobs
        finally:
            svc.drain()
    assert not dist.is_initialized()
    return out


def test_service_world_of_one_equals_reference_mesh(serve_world1):
    """The port's service over a world of one against the reference's
    over its 1x1 mesh, the same requests: ``/align`` over the threshold
    takes ``path: "dist"`` with the same rows and ``msa_id``, under it the
    coalesced path; ``/tree`` tiled at RF 0 (equal Newick, or an NJ tie
    rooted apart); ``/search`` the same ``search_id`` and hits."""
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.search import SearchIndex as JIndex
    from repro.serve import MSAService as JService
    from repro.serve import ServiceConfig as JServiceConfig
    from test_torch_msa_run import _splits
    names, seqs, _, _ = _search_db()
    ref = JService(_serve_config(jmesh((1, 1)), JIndex.build(names, seqs),
                                 JServiceConfig))
    try:
        want = _serve_requests(ref, ml=False)
    finally:
        ref.drain()
    got = serve_world1
    fam = _serve_inputs()[0]
    assert got["align"]["path"] == want["align"]["path"] == "dist"
    assert got["align2"]["path"] == "dist"
    assert got["align_small"]["path"] == "coalesced"
    for k in ("align", "align_small", "align2"):
        assert got[k]["alignment"] == want[k]["alignment"], k
        assert got[k]["path"] == want[k]["path"]
    for k in ("tree", "tree_again"):
        assert got[k]["msa_id"] == want[k]["msa_id"]
        assert got[k]["backend"] == want[k]["backend"]
        assert got[k]["cached_tree"] == want[k]["cached_tree"]
        if got[k]["newick"] != want[k]["newick"]:
            assert _splits(got[k]["newick"], fam.names) == \
                _splits(want[k]["newick"], fam.names)
    for k in ("search", "search2"):
        assert got[k] == want[k], k
    assert got["search"]["stats"]["seed"] == "mesh"


def test_service_over_two_ranks_equals_world_of_one(serve_world1,
                                                    serve_world2):
    """The same requests to the service over 2 ``gloo`` ranks: every
    response equal to the world of one's (ML tree and bootstrap labels
    included); two mesh requests at once from two handler threads on rank
    0 both finish; rank 0's drain stops the follower, which ran every
    mesh job rank 0 ran (the tree cache hit runs none)."""
    rank0, rank1 = (dict(r["serve"]) for r in serve_world2)
    jobs = rank0.pop("mesh_jobs")
    assert rank1 == {"followed": jobs}
    assert jobs == serve_world1["mesh_jobs"] == 6
    want = {k: v for k, v in serve_world1.items() if k != "mesh_jobs"}
    assert rank0.keys() == want.keys()
    for k in want:
        assert rank0[k] == want[k], k
    assert rank0["tree"]["backend"] == "tiled-exact"
    assert rank0["tree_again"]["cached_tree"] is True
    assert rank0["tree_ml"]["refine"] == "ml"


def test_service_fault_on_one_rank_stops_the_mesh(tmp_path):
    """A fault on rank 1 only, while rank 0 waits in the job's
    collectives, is a prompt 503 on rank 0, not a wait for the process
    group's timeout: rank 1 leaves the group and re-raises, the mesh stops,
    a later mesh request is a 503 at once and one under the threshold
    still aligns. An error of the data on every rank before it is a 400,
    and the mesh goes on."""
    t0 = time.time()
    rank0, rank1 = (r["serve_fault"] for r in
                    _spawn(tmp_path, (2, 1), ["serve_fault"]))
    assert time.time() - t0 < WORLD_TIMEOUT
    status, body, _ = rank0["data"]
    assert status == 400 and "an error of the data" in body["error"]
    status, body, _ = rank0["ok"]
    assert status == 200 and body["path"] == "dist"
    status, body, secs = rank0["fault"]
    assert status == 503 and "mesh is stopped" in body["error"]
    assert secs < 30
    status, body, secs = rank0["after"]
    assert status == 503 and "mesh stopped by a fault" in body["error"]
    assert secs < 5
    status, body, _ = rank0["small"]
    assert status == 200 and body["path"] == "coalesced"
    assert rank0["calls"] == 3
    assert rank1 == {"raised": "planted: a fault on rank 1", "calls": 3}
