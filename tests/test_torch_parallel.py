"""The port's parallel layer (qoipp_tpu_torch.parallel) against the JAX
package's on the cases of tests/test_parallel.py and
benchmarks/multiprocess_sim.py, bit-exact: dp decode (whole output and
checksum), dp encode (streams, lengths, the overflow error), sp decode
(emits, prevs and fixpoint rounds, the adversarial INDEX stream included)
and sp encode (RGB and RGBA, an uneven last shard), each also against the
oracle; the hybrid mesh's shape rule and the multi-rank dry run.

The port runs as local gloo jobs on the CPU (parallel.launch.run_ranks):
one job of 4 ranks and one of 8, each spawned once for the module by a
fixture that runs every case and writes each rank's outputs to an .npz
file (tests/torch_parallel_jobs.py).  JAX's make_mesh takes all 8 virtual
CPU devices, so it runs at a mesh whose axis matches the port's world:
(2, 4) for seq 4, (4, 2) for data 4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_jobs as jobs
from qoipp_tpu import Channels as JChannels
from qoipp_tpu import Desc as JDesc
from qoipp_tpu.models.pipeline import BatchPipeline as JaxPipeline
from qoipp_tpu.ops import boundary as jbnd
from qoipp_tpu.ops import decode as jdec
from qoipp_tpu.parallel import mesh as jmesh
from qoipp_tpu.parallel import sharded as jsharded
from qoipp_tpu_torch.parallel import mesh as mesh_mod
from qoipp_tpu_torch.parallel.dryrun import dryrun_multichip
from qoipp_tpu_torch.parallel.launch import run_ranks

JOB_TIMEOUT = 120  # s; a job takes a few seconds


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return jobs.run_job(tmp_path_factory.mktemp("world4"), jobs.inputs4,
                        jobs.world4, 4, "cpu", JOB_TIMEOUT)


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return jobs.run_job(tmp_path_factory.mktemp("world8"), jobs.inputs8,
                        jobs.world8_hybrid, 8, "cpu", JOB_TIMEOUT)


def _check_dp_decode(job, prefix, jmesh_, jaxis, data_ranks=None):
    got = jobs.check_dp_decode(job, prefix, data_ranks)
    _, blobs = job["want"][prefix]
    d = jobs._desc(job["inp"], f"{prefix}_dec")
    jpipe = JaxPipeline(JDesc(d.width, d.height, JChannels(int(d.channels))))
    streams, sizes = jpipe.pack_streams(blobs)
    want, checksum = jsharded.make_dp_decode(jpipe, jmesh_, jaxis)(
        jnp.asarray(streams), jnp.asarray(sizes))
    assert np.array_equal(got, np.asarray(want))
    for r in job["ranks"]:  # every rank holds the whole batch's checksum
        assert int(r[f"{prefix}_checksum"]) == int(checksum)


def test_dp_decode_matches_jax(world4):
    _check_dp_decode(world4, "dp", jmesh.make_mesh((4, 2)), "data")


def test_dp_encode_matches_jax(world4):
    got, lengths = jobs.check_dp_encode(world4)
    want, want_len = jsharded.make_dp_encode(
        JaxPipeline(JDesc(48, 32, JChannels.RGB)), jmesh.make_mesh((4, 2)))(
        jnp.asarray(world4["inp"]["dp_enc_packed"]))
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(lengths, np.asarray(want_len))


def test_dp_encode_overflow_names_global_images(world4):
    inp = world4["inp"]
    tight = JaxPipeline(JDesc(40, 32, JChannels.RGBA),
                        max_encode_len=int(inp["dp_ovf_cap"]))
    with pytest.raises(ValueError) as e:
        jsharded.make_dp_encode(tight, jmesh.make_mesh((4, 2)))(
            jnp.asarray(inp["dp_ovf_packed"]))
    # on ranks 1, 2 and 3; every rank raises the same error
    assert jobs.overflow_images(e.value) == jobs.OVERFLOW_IMAGES
    for r in world4["ranks"]:
        assert jobs.overflow_images(r["dp_overflow"]) == jobs.OVERFLOW_IMAGES


@pytest.mark.parametrize("name", ["sp", "adv"])
def test_sp_decode_matches_jax(world4, name):
    got_e, got_p, rounds = jobs.check_sp_decode(world4, name)
    desc, _, blob = world4["want"][name]
    region = jnp.asarray(world4["inp"][f"{name}_region"])
    qb = region.shape[0] - 8
    info = jbnd.analyze_region(region[:qb], jnp.int32(blob.size - 22),
                               jnp.int32(desc.width * desc.height))
    fields = jax.jit(jdec.classify_dense, static_argnames=("qb",))(
        region, qb, info["real"])
    emits, prevs, want_rounds = jsharded.make_sp_decode(
        jmesh.make_mesh((2, 4)), qb, jobs.SP_TILES, with_rounds=True)(*fields)
    assert np.array_equal(got_e, np.asarray(emits))
    assert np.array_equal(got_p, np.asarray(prevs))
    want_rounds = int(np.asarray(want_rounds).max())
    assert rounds == [want_rounds] * 4
    assert want_rounds <= 4 * jobs.SP_TILES + 2
    if name == "adv":  # the O(n_tiles) worst case, far from O(1)
        assert want_rounds >= 4


def _check_sp_encode(job, name, jmesh_, seq_ranks):
    parts = jobs.check_sp_encode(job, name, seq_ranks)
    n_local, n_last, ch = (int(x) for x in job["inp"][f"{name}_shape"])
    bodies, lengths = jsharded.make_sp_encode(jmesh_, n_local, ch)(
        jnp.asarray(job["inp"][f"{name}_packed"]), jnp.int32(n_last))
    bodies, lengths = np.asarray(bodies), np.asarray(lengths)
    for s, (body, length) in enumerate(parts):
        assert length == lengths[s]
        assert np.array_equal(body, bodies[s, :length])


@pytest.mark.parametrize("name", ["enc_rgb", "enc_rgba"])
def test_sp_encode_matches_jax(world4, name):
    _check_sp_encode(world4, name, jmesh.make_mesh((2, 4)), [0, 1, 2, 3])


def test_bad_mesh_shape_raises_on_every_rank(world4):
    for r in world4["ranks"]:
        assert "!= 4 ranks" in str(r["bad_shape"])


def test_hybrid_mesh_matches_jax(world8):
    m = jmesh.make_hybrid_mesh(hosts=2)
    want = tuple(m.shape[a] for a in ("host", "data", "seq"))
    assert want == (2, 1, 4)  # seq takes the 4 ranks of a host
    for r, rank in enumerate(world8["ranks"]):
        assert tuple(rank["shape"]) == want
        assert tuple(rank["shape_env"]) == want  # LOCAL_WORLD_SIZE 4
        assert tuple(rank["coords"]) == np.unravel_index(r, want)
    # dp over (host, data): the ranks of seq coordinate 0 hold the blocks
    for prefix in ("hy", "sim"):
        _check_dp_decode(world8, prefix, m, ("host", "data"), [0, 4])
    # sp encode rides the innermost axis: the first host's ranks
    _check_sp_encode(world8, "hy_sp", m, [0, 1, 2, 3])


def test_dryrun_multichip():
    """Every rank holds its dp, sp decode and sp encode results to the
    oracle and the checksum to the sum of the ranks' outputs; the job
    raises otherwise."""
    out = dryrun_multichip(4, device_type="cpu", timeout=JOB_TIMEOUT)
    assert [o["rank"] for o in out] == [0, 1, 2, 3]
    assert len({o["checksum"] for o in out}) == 1


@pytest.mark.parametrize("world", range(1, 17))
def test_hybrid_shape_rule_matches_jax(monkeypatch, world):
    """JAX's make_hybrid_mesh body on `world` stand-in devices, its Mesh
    replaced by the shape of the array it is given."""
    monkeypatch.setattr(jmesh.jax, "devices", lambda: list(range(world)))
    monkeypatch.setattr(jmesh, "Mesh", lambda arr, axis_names: arr.shape)
    for hosts in (h for h in range(1, world + 1) if world % h == 0):
        assert mesh_mod.hybrid_shape(world, hosts) == jmesh.make_hybrid_mesh(
            hosts=hosts)
    with pytest.raises(ValueError):
        mesh_mod.hybrid_shape(world + 1, world) if world > 1 else \
            mesh_mod.hybrid_shape(3, 2)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh(device_type="cpu")


def test_failed_rank_fails_the_job():
    """Rank 1 raises while rank 0 waits in a barrier: the job raises with
    rank 1's error and rank 0 is killed, not left hanging."""
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        run_ranks(jobs.fails_on_rank1, 2, "gloo", "cpu", JOB_TIMEOUT)
