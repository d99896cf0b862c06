"""The ring all-reduces K7 and K8 of the port (``parallel/ring_kernel.py``,
``parallel/collectives.py``) on the CPU.

- one launch of four processes over gloo, with sub-groups of 2 and 3 ranks:
  the plain versions of K7 and K8 (what a CPU tensor runs) at N = 2, 3, 4
  against the fixed-order numpy sums (exactly), against JAX's
  interpret-mode ``pallas_psum`` on a CPU mesh of the same N, and the same
  bits on every rank; ``pallas_psum_tree``, ``allreduce_tree`` and two
  collective ids in one step;
- ``algorithm="auto"`` against JAX's rule;
- the kernels' segments and the host's walk over them
  (``ops/csrc/collectives.cuh``) built with g++, N threads playing the
  ranks over shared memory: bit for bit against the plain versions, 50
  calls in a row, ranks that start late, payloads off a 16-byte boundary,
  a wait that never completes, and the shared host segment's life.
"""

import ctypes
import functools
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from sdf3d_tpu.parallel import collectives as jax_collectives
from sdf3d_tpu.parallel import make_mesh as jax_make_mesh
from sdf3d_tpu.parallel.mesh import tile_axis as jax_tile_axis
from sdf3d_tpu_torch.ops import _build
from sdf3d_tpu_torch.parallel import allreduce_tree, collectives, make_mesh, pallas_psum, pallas_psum_tree
from sdf3d_tpu_torch.parallel.ring_kernel import rs_ag_chunk

REPO = pathlib.Path(__file__).resolve().parents[1]
SIZES = (2, 3, 4)
DTYPES = ("float32", "float64")
ALGORITHMS = ("ring", "rs_ag", "auto")


def _payloads(n):
    return (1, 9, 130, 5000, collectives._rs_ag_threshold(n) + 5)


def _inputs(n, size, dtype):
    """The ranks' vectors (n, size), from a seed."""
    rng = np.random.default_rng(1000 * n + size)
    return rng.standard_normal((n, size)).astype(dtype)


def ring_order(xs):
    """K7's sum: the ranks' vectors added in rank order."""
    acc = xs[0].copy()
    for x in xs[1:]:
        acc = acc + x
    return acc


def rs_ag_order(xs):
    """K8's sum: the vector padded to two streams of N chunks; chunk c is
    reduced along the ring from rank c (x_c + x_{c+1} + ...)."""
    n, size = xs.shape
    m = rs_ag_chunk(size, n)
    pad = np.zeros((n, 2 * n * m), xs.dtype)
    pad[:, :size] = xs
    p = pad.reshape(n, 2, n, m)
    out = np.empty((2, n, m), xs.dtype)
    for c in range(n):
        acc = p[c, :, c].copy()
        for j in range(1, n):
            acc = acc + p[(c + j) % n, :, c]
        out[:, c] = acc
    return out.reshape(-1)[:size]


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


WORKER = r"""
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
port, rank, outdir, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import torch.distributed as dist
from sdf3d_tpu_torch.parallel import allreduce_tree, launch, make_mesh, pallas_psum, pallas_psum_tree

launch.initialize(f"tcp://127.0.0.1:{port}", world_size=4, rank=rank, device="cpu")
spec = json.load(open(os.path.join(outdir, "spec.json")))
inputs = np.load(os.path.join(outdir, "inputs.npz"))
groups = {2: dist.new_group([0, 1]), 3: dist.new_group([0, 1, 2]), 4: None}
out = {}
for n in spec["sizes"]:
    if rank >= n:
        continue
    mesh = make_mesh("cpu", group=groups[n])
    for key in spec["cases"][str(n)]:
        x = torch.from_numpy(inputs[key][rank])
        for alg in spec["algorithms"]:
            out[f"{key}/{alg}"] = pallas_psum(x, mesh, alg).numpy()
        out[f"{key}/ring_interpret"] = pallas_psum(x, mesh, "ring", interpret=True).numpy()
    leaves = [torch.from_numpy(inputs[f"tree{n}_{i}"][rank]) for i in range(3)]
    for i, t in enumerate(pallas_psum_tree(leaves, mesh)):
        out[f"tree{n}_{i}"] = t.numpy()
    for name in ("pallas_ring", "pallas_rs_ag", "pallas_ring_interpret"):
        for i, t in enumerate(allreduce_tree(leaves, name, mesh)):
            out[f"allreduce{n}_{name}_{i}"] = t.numpy()
    # Two reductions back to back in one step, with distinct ids.
    a = pallas_psum(torch.from_numpy(inputs[f"tree{n}_1"][rank]), mesh, "ring", collective_id=2)
    b = pallas_psum(torch.from_numpy(inputs[f"tree{n}_2"][rank]), mesh, "rs_ag", collective_id=3)
    out[f"two_ids{n}_a"], out[f"two_ids{n}_b"] = a.numpy(), b.numpy()
np.savez(os.path.join(outdir, f"out_r{rank}.npz"), **out)
launch.shutdown()
"""


def _jax_psums(inputs, cases):
    """JAX's interpret-mode ``pallas_psum`` of the float32 cases: ``auto``
    on every payload (K7 below the threshold, K8 above it) and K8 at 9
    elements, one program per mesh size."""
    got = {}
    for n in SIZES:
        mesh = jax_make_mesh(jax.devices("cpu"), n_devices=n)
        keys = [k for k in cases[str(n)] if k.endswith("float32")]
        calls = [(k, "auto") for k in keys] + [(f"n{n}_9_float32", "rs_ag")]

        @functools.partial(jax.shard_map, mesh=mesh, in_specs=PS(jax_tile_axis, None),
                           out_specs=PS(jax_tile_axis, None), check_vma=False)
        def f(*locals_):
            return tuple(jax_collectives.pallas_psum(loc[0], n, interpret=True, algorithm=alg,
                                                     collective_id=2 + i)[None]
                         for i, (loc, (_, alg)) in enumerate(zip(locals_, calls)))

        outs = f(*(jnp.asarray(inputs[k]) for k, _ in calls))
        for (k, alg), o in zip(calls, outs):
            got[f"{k}/{alg}"] = np.asarray(o)
    return got


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four processes' results (one launch for the module), the inputs
    and JAX's interpret-mode sums (computed while the processes run)."""
    outdir = tmp_path_factory.mktemp("ring")
    inputs, cases = {}, {}
    for n in SIZES:
        cases[str(n)] = []
        for size in _payloads(n):
            for dtype in DTYPES:
                key = f"n{n}_{size}_{dtype}"
                inputs[key] = _inputs(n, size, dtype)
                cases[str(n)].append(key)
        rng = np.random.default_rng(n)
        for i, shape in enumerate([(3,), (2, 4), (5, 1, 2)]):
            inputs[f"tree{n}_{i}"] = rng.standard_normal((n,) + shape).astype(np.float32)
    np.savez(outdir / "inputs.npz", **inputs)
    (outdir / "spec.json").write_text(json.dumps({"sizes": SIZES, "cases": cases, "algorithms": ALGORITHMS}))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(port), str(r), str(outdir), str(REPO)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        want = _jax_psums(inputs, cases)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [dict(np.load(outdir / f"out_r{r}.npz")) for r in range(4)]
    return inputs, cases, outs, want


@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_fixed_order_sums(n, ranks):
    """Every rank holds the same bits, equal to the kernels' order of
    addition (K7 rank order, K8 each chunk along the ring) in numpy; ``auto``
    runs the algorithm JAX's rule picks; ``interpret`` runs the same plain
    version."""
    inputs, cases, outs, _ = ranks
    for key in cases[str(n)]:
        xs = inputs[key]
        want = {"ring": ring_order(xs), "rs_ag": rs_ag_order(xs)}
        want["auto"] = want[collectives.resolve_algorithm("auto", xs.shape[1], n)]
        want["ring_interpret"] = want["ring"]
        for alg, w in want.items():
            for r in range(n):
                got = outs[r][f"{key}/{alg}"]
                assert got.dtype == xs.dtype and got.shape == w.shape
                np.testing.assert_array_equal(got, w, err_msg=f"{key} {alg} rank {r}")
        if xs.dtype == np.float64:
            np.testing.assert_allclose(want["ring"], xs.sum(0), rtol=1e-12, atol=1e-12 * np.abs(xs).max())


@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_jax_interpret(n, ranks):
    """The plain K7/K8 against JAX's interpret-mode ``pallas_psum`` in
    float32 (JAX adds in other orders: rtol 1e-6, atol 1e-6·max|x|)."""
    inputs, _, outs, want = ranks
    for name, w in want.items():
        if not name.startswith(f"n{n}_"):
            continue
        key, alg = name.split("/")
        xs = inputs[key]
        for r in range(n):
            np.testing.assert_allclose(outs[r][f"{key}/{alg}"], w[r], rtol=1e-6, atol=1e-6 * np.abs(xs).max(),
                                       err_msg=name)


@pytest.mark.parametrize("n", SIZES)
def test_psum_tree_allreduce_tree_and_two_ids(n, ranks):
    """``pallas_psum_tree`` over shaped float32 leaves equals the leaf-wise
    rank-order sums; ``allreduce_tree``'s ring values sum in float64 and
    give each leaf back in its shape and type; two collective ids in one
    step."""
    inputs, _, outs, _ = ranks
    for r in range(n):
        for i in range(3):
            leaf = inputs[f"tree{n}_{i}"]
            np.testing.assert_array_equal(outs[r][f"tree{n}_{i}"], ring_order(leaf))
            for name in ("pallas_ring", "pallas_rs_ag", "pallas_ring_interpret"):
                got = outs[r][f"allreduce{n}_{name}_{i}"]
                assert got.dtype == np.float32 and got.shape == leaf.shape[1:]
                np.testing.assert_array_equal(got, leaf.astype(np.float64).sum(0).astype(np.float32))
        np.testing.assert_array_equal(outs[r][f"two_ids{n}_a"], ring_order(inputs[f"tree{n}_1"]))
        np.testing.assert_array_equal(outs[r][f"two_ids{n}_b"], rs_ag_order(
            inputs[f"tree{n}_2"].reshape(n, -1)).reshape(inputs[f"tree{n}_2"].shape[1:]))


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_auto_picks_as_jax(n):
    thr = jax_collectives._rs_ag_threshold(n)
    assert collectives._rs_ag_threshold(n) == thr
    for size in (1, 9, thr - 1, thr, thr + 5, 70001):
        want = "rs_ag" if size >= jax_collectives._rs_ag_threshold(n) else "ring"
        assert collectives.resolve_algorithm("auto", size, n) == want
    assert collectives.resolve_algorithm("ring", 10 ** 6, n) == "ring"
    with pytest.raises(ValueError, match="algorithm"):
        collectives.resolve_algorithm("tree", 9, n)


def test_mesh_of_one_returns_the_input():
    mesh = make_mesh("cpu")
    x = torch.arange(5.0)
    assert pallas_psum(x, mesh) is x
    leaves = [torch.ones(3), torch.zeros(2, 2, dtype=torch.float64)]
    for name in collectives.RING_ALLREDUCES:
        for a, b in zip(allreduce_tree(leaves, name, mesh), leaves):
            assert a is b
    assert pallas_psum_tree(leaves, mesh) == leaves


_HOST = {}


def _host_library():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    if "lib" not in _HOST:
        _HOST["lib"] = _build.KernelLibraries(tempfile.mkdtemp(prefix="sdf3d_coll_"), host=True).load(
            "", "collectives")
    return _HOST["lib"]


def _host_run(kind, xs, calls=1, absent=-1, spin_s=20.0, late=-1, late_s=0.0):
    """The g++ build's ``calls`` calls on ``len(xs)`` threads, rank ``late``
    starting ``late_s`` after the others: ``(out, status)``, out (N, n) (K8:
    the padded vector's)."""
    lib = _host_library()
    n = xs.shape[0]
    xs = np.ascontiguousarray(xs)
    out = np.zeros_like(xs) if kind == "ring" else np.zeros((n, 2 * n * rs_ag_chunk(xs.shape[1], n)), xs.dtype)
    status = (ctypes.c_int * (n * 8))()
    fn = lib.sdf3d_ring_allreduce_host if kind == "ring" else lib.sdf3d_rs_ag_host
    assert fn(n, xs.ctypes.data, out.ctypes.data, xs.shape[1], xs.itemsize, calls, absent, late, int(late_s * 1e9),
              int(spin_s * 1e9), status) == 0
    return out, np.asarray(status).reshape(n, 2, 4)


@pytest.mark.parametrize("n", SIZES)
def test_host_build_matches_plain(n, ranks):
    """The kernels' own schedule walks and index arithmetic, built with g++
    and run on N threads (three calls in a row, both parity sets), give the
    plain versions' bits on every rank."""
    inputs, cases, outs, _ = ranks
    for key in cases[str(n)]:
        xs = inputs[key]
        for kind in ("ring", "rs_ag"):
            out, status = _host_run(kind, xs, calls=3)
            assert not status.any()
            for r in range(n):
                np.testing.assert_array_equal(out[r, :xs.shape[1]], outs[r][f"{key}/{kind}"], err_msg=f"{key} {kind}")


@pytest.mark.parametrize("kind", ["ring", "rs_ag"])
def test_host_build_many_calls(kind):
    """50 calls in a row over the two parity sets and rising epochs."""
    xs = _inputs(4, 70001, "float64")
    out, status = _host_run(kind, xs, calls=50)
    assert not status.any()
    want = ring_order(xs) if kind == "ring" else rs_ag_order(xs)
    for r in range(4):
        np.testing.assert_array_equal(out[r, :70001], want)


@pytest.mark.parametrize("kind", ["ring", "rs_ag"])
def test_host_build_wait_times_out(kind):
    """A rank that never arrives: its neighbours' waits give up at the limit
    and write the op and step into their status words instead of hanging."""
    xs = _inputs(3, 100, "float32")
    out, status = _host_run(kind, xs, absent=1, spin_s=0.2)
    assert not status[1].any()  # the absent rank ran nothing
    # Rank 2 waits for its step-0 arrival from rank 1 on both streams.
    assert status[2].tolist() == [[1, 1, 0, 0], [1, 1, 0, 0]]
    # Rank 0 received rank 2's step-0 chunk; it then waits on a step rank 1
    # never completes.
    assert (status[0, :, 0] == 1).all() and set(status[0, :, 1]) <= {1, 2}


@pytest.mark.parametrize("kind", ["ring", "rs_ag"])
@pytest.mark.parametrize("n", SIZES)
def test_host_build_staggered_start(n, kind):
    """One rank starts its calls 0.2 s after the others: the host waits
    hold the others at their first wait, and every rank still gets the
    kernels' order of addition bit for bit (three calls, both parity sets)."""
    xs = _inputs(n, 130, "float64")
    for late in (0, n - 1):
        out, status = _host_run(kind, xs, calls=3, late=late, late_s=0.2)
        assert not status.any()
        want = ring_order(xs) if kind == "ring" else rs_ag_order(xs)
        for r in range(n):
            np.testing.assert_array_equal(out[r, :130], want, err_msg=f"late rank {late}, rank {r}")


@pytest.mark.parametrize("n, dtype", [(3, "float64"), (3, "float32"), (4, "float32")])
def test_host_build_rs_ag_acks(n, dtype):
    """K8 at N >= 3 (where a slot is rewritten within a call, behind the
    right neighbour's ack) with 70001 values, 50 calls in a row."""
    xs = _inputs(n, 70001, dtype)
    out, status = _host_run("rs_ag", xs, calls=50)
    assert not status.any()
    want = rs_ag_order(xs)
    for r in range(n):
        np.testing.assert_array_equal(out[r, :70001], want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size", [9, 130, 4482])
@pytest.mark.parametrize("n", SIZES)
def test_host_build_odd_offsets(n, size, dtype):
    """Payloads whose K7 half B or K8 chunks start off a 16-byte boundary
    (h = ceil(size / 2) or m = ceil(size / 2N) odd): the slots take their
    vector's phase and the copies split into a scalar head, 16-byte items
    and a scalar tail, with the plain versions' bits."""
    m = rs_ag_chunk(size, n)
    assert ((size + 1) // 2) % 2 == 1 or m % 2 == 1
    xs = _inputs(n, size, dtype)
    for kind, want in (("ring", ring_order(xs)), ("rs_ag", rs_ag_order(xs))):
        out, status = _host_run(kind, xs, calls=2)
        assert not status.any()
        for r in range(n):
            np.testing.assert_array_equal(out[r, :size], want, err_msg=f"{kind} rank {r}")
            assert not out[r, size:].any()  # K8: the padding sums to zero


def test_shared_segment_lifecycle():
    """The shared host segment of a buffer set: the creator maps a new
    zeroed POSIX shared-memory object of whole pages, a second mapping of
    the name sees its stores, a second create of the name fails, and after
    the unlink and unmaps nothing is left under /dev/shm."""
    lib = _host_library()
    nbytes = ctypes.c_longlong()
    assert lib.sdf3d_coll_sync_bytes(0, 4, ctypes.byref(nbytes)) == 0
    assert nbytes.value > 0 and nbytes.value % 4096 == 0
    name = f"/sdf3d_coll_test_{os.getpid()}".encode()
    a, b = ctypes.c_void_p(), ctypes.c_void_p()
    assert lib.sdf3d_coll_shm_open(name, nbytes.value, 1, ctypes.byref(a)) == 0
    try:
        assert lib.sdf3d_coll_shm_open(name, nbytes.value, 1, ctypes.byref(b)) != 0  # EEXIST
        assert lib.sdf3d_coll_shm_open(name, nbytes.value, 0, ctypes.byref(b)) == 0
        words_a = (ctypes.c_int * 8).from_address(a.value)
        assert list(words_a) == [0] * 8
        words_a[2] = 7
        status = (ctypes.c_int * 8)()
        assert lib.sdf3d_coll_status(0, 4, b, 0, status) == 0
        assert list(status) == [0, 0, 7, 0, 0, 0, 0, 0]
    finally:
        assert lib.sdf3d_coll_shm_unlink(name) == 0
    assert not pathlib.Path("/dev/shm", name.decode().lstrip("/")).exists()
    assert lib.sdf3d_coll_shm_close(a, nbytes.value) == 0
    assert lib.sdf3d_coll_shm_close(b, nbytes.value) == 0
    assert lib.sdf3d_coll_shm_open(name, nbytes.value, 0, ctypes.byref(b)) != 0  # ENOENT
