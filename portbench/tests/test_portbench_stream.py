"""The streaming cells (``stream8k_decode``, ``stream8k_encode``) at CPU
sizes: each kind runs through the harness on a small stand-in of the 8K
mosaic configuration, correct, and wrong under its control; the ten
metric files of the streaming cells read numbers from made-up program
records and device traces; and every file the benchmark held before the
streaming cells were added beside it is byte-equal to what it was."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from portbench import harness, mosaic, program
from portbench.program import ProgramRecord
from portbench.roofline import Work
from portbench.spec import HERE, Spec
from portbench.trace import DeviceTrace, Event
from portbench_small import run_cpu, small_spec
from qoipp_tpu_torch.utils import tracing
from qoipp_tpu_torch.utils.tracing import Span

CELLS = ("stream8k_decode", "stream8k_encode")
MS = 1_000_000  # ns


def stream_spec(tmp) -> Spec:
    """portbench_small's spec with the streaming configuration cut to a 4 x
    4 mosaic of its 48 x 40 RGB file (192 x 160), fed in 4,000-byte
    pieces (torn chunks at most seams) and 4,096-pixel slices, one warm-up
    and one traced call."""
    spec = small_spec(tmp)
    path = spec.home / "configs" / "stream_8k_photo_rgb.json"
    c = json.loads(path.read_text())
    c.update(dir="corpus", digests="pb/corpus/small.sha256",
             files=["f2.qoi"], width=192, height=160)
    path.write_text(json.dumps(c))
    for name, kw in (("stream_decode_1mib_feeds", dict(feed_bytes=4000)),
                     ("stream_encode_256kpx_windows", dict(slice_px=4096))):
        path = spec.home / "traffic" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        warmup_calls=1, trace_calls=1, **kw)))
    return spec


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return stream_spec(tmp_path_factory.mktemp("stream"))


@pytest.mark.parametrize("control", (0, 1))
@pytest.mark.parametrize("cell", CELLS)
def test_stream_cell_runs_on_cpu(spec, cell, control):
    r = run_cpu(spec, cell, seconds=0.2, control=control)
    assert r["correct"] is (not control), r["checks"]
    assert r["compared"] == min(2, r["attempted"]) >= 1
    wrong = [v["value"] for v in r["checks"].values()]
    assert (max(wrong) > 0) == bool(control)
    assert set(r["metrics"]) == {
        "decode_mpix_s" if cell == "stream8k_decode" else "encode_mpix_s",
        "setup_s"}


def test_traced_stream_encode_reads_the_program(spec, monkeypatch):
    """A traced run on the CPU (made-up device events beside the real host
    profile, as the profiler keeps none here): the encode cell's program
    metrics read the port's spans."""
    real = harness.read_profile

    def with_device(prof, calls):
        t = real(prof, calls)
        return t._replace(device=[
            Event(k, t.lo, t.lo + 1e-6) for k in (
                "fields_kernel(int)", "compact_kernel(int)",
                "emit_kernel(int)", "at::native::elementwise_kernel")])

    monkeypatch.setattr(harness, "read_profile", with_device)
    r = run_cpu(spec, "stream8k_encode", seconds=0.2, trace=1)
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["host_upload_ms.stream_encode"] > 0
    assert m["host_wait_ms.stream_encode"] > 0
    assert 0 <= m["idle_pct.stream_encode"] < 100
    assert m["torch_passes_ms.stream_encode"] > 0
    assert not tracing.enabled()


def test_mosaic_config_refuses_a_wrong_geometry(spec):
    c = spec.config("stream_8k_photo_rgb")
    header, raws = mosaic.from_config(spec.root, c, seed=5, images=2)
    assert (header.width, header.height) == (192, 160)
    assert [r.size for r in raws] == [192 * 160 * 3] * 2
    assert not np.array_equal(raws[0], raws[1])
    with pytest.raises(ValueError, match="do not make"):
        mosaic.from_config(spec.root, dict(c, width=500), seed=5)


# -- the ten metric files on made-up records ----------------------------------

def _span(name, sid, request, start_ms, end_ms):
    return Span(name, sid, -1, request, 1, start_ms * MS, end_ms * MS)


def _record(direction):
    """A harness record of two calls holding every span, counter and
    device event the streaming cells' metrics read."""
    t = tracing.Trace()
    t.spans = [_span("host.plan", 1, 0, 0, 3), _span("host.plan", 2, 1, 5, 6),
               _span("host.upload", 3, 0, 6, 8),
               _span("host.fetch", 4, 0, 8, 12), _span("host.sync", 5, 1, 12,
                                                       13),
               _span("host.plan", 6, -1, 20, 90)]  # outside a call
    t.counters = {(0, "stream_windows"): 3, (1, "stream_windows"): 3,
                  (0, "stream_rounds"): 20, (1, "stream_rounds"): 22,
                  (-1, "stream_rounds"): 99}
    prec = ProgramRecord(direction, 2, 2000, t, None)
    dev = [Event("void replay_kernel<true>(int)", 0.1, 0.3),
           Event("fields_kernel(int)", 0.3, 0.4),
           Event("fields_summary_kernel(int)", 0.4, 0.5),
           Event("at::native::vectorized_elementwise_kernel", 0.5, 0.9),
           Event("Memcpy DtoH (Device -> Pageable)", 0.9, 1.0)]
    tr = DeviceTrace(dev, [], 0.0, 2.0, 2)
    # the work each kind counts: K5's bound 10 ms, E1's 20 ms a call
    work = ({"k5": Work(3.35e12 * 0.01, 0)} if direction == "decode"
            else {"e1": Work(0, 67e12 * 0.02)})
    return harness.Record(direction, 1.0, 1.0, [], 2, 2000, [], tr, work,
                          "NVIDIA H100 80GB HBM3", prec)


# each metric: (its direction, what it reads from _record)
READS = {
    "host_plan_ms.stream_decode": ("decode", 2.0),  # (3 + 1) ms / 2 calls
    "host_wait_ms.stream_decode": ("decode", 2.5),  # (4 + 1) / 2
    "rounds_per_window.stream_decode": ("decode", 7.0),  # 42 / 6
    "k5_roofline.stream_decode": ("decode", 10.0),  # 10 ms over 100 ms
    "idle_pct.stream_decode": ("decode", 55.0),  # 0.9 of 2 s busy
    "host_upload_ms.stream_encode": ("encode", 1.0),
    "host_wait_ms.stream_encode": ("encode", 2.5),
    "e1_roofline.stream_encode": ("encode", 20.0),  # 20 ms over 100 ms
    "torch_passes_ms.stream_encode": ("encode", 200.0),  # 0.4 s / 2
    "idle_pct.stream_encode": ("encode", 55.0),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_stream_metric_reads_its_record(name):
    direction, want = READS[name]
    other = "encode" if direction == "decode" else "decode"
    read = Spec().reader(name)
    assert read(_record(direction)) == pytest.approx(want)
    assert read(_record(other)) is None
    bare = _record(direction)._replace(program=None, trace=None)
    assert read(bare) is None


def test_every_stream_metric_is_tested():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    stream = {m["name"] for m in bench["per_layer"]
              if set(m.get("workloads", ())) & set(CELLS)}
    assert stream == set(READS)


# -- the files the streaming cells were added beside ---------------------------

# SHA-256 of every file of portbench/ before the streaming cells: they came
# as new files alone, with their BENCHMARK.json entries
BEFORE = {
    "__init__.py":
        "0d21598ebf26c39a2c72274b2d86ed9c48616a75d2c959fd25e8c98363c29474",
    "configs/batch_1080p_rgb.json":
        "0d9f835e37270591cf1aa9a9752f4e0b63f38b8b578bfa7cb34c6d248e72fb30",
    "configs/serving_mixed_corpus.json":
        "2381a3e7be9cb4d4b9e2f1804a226e8df68dd9e886022664bd394ef6ff82bccf",
    "corpus.py":
        "384b9e84b71e06d2bb247a1b28a89cb4a7d32fbe5e9db588d6c435b9d5235e21",
    "corpus/local_corpus.sha256":
        "6a3a3cb001e7194f5fe3a488fb770173a679df924f3150ebac1fd0363a57a347",
    "drivers.py":
        "42ea194ccef670cce634ba84ca662a29e4d40281c05e0efc0739d99a9ff04bf8",
    "generator.py":
        "af7c2b2a804713667bc793e1ded28e8cf561c1f429d2378e9cec36086c306098",
    "guard.py":
        "50b88f9261fef71747cd296511bb5054275c84e205e164f101f80f912972a959",
    "harness.py":
        "69b1747d172790ecc17d78a1277fe92b139762d087d0402ee56817bf3b4ee9b6",
    "kinds/batch_decode.py":
        "a01ea00fd2e99b56d90256066a933faa289c11434dd1b164c62c65b7a3e88ae6",
    "kinds/batch_encode.py":
        "5d0704ed010c7ee1a2dbf18f89eda44623ff504b736709738162b5919a023ee5",
    "kinds/serving_decode.py":
        "c330c37985ad2b21b6d408a29b21c38fc68a6aef53860b6f9b9da92ebc8b7aa2",
    "kinds/serving_encode.py":
        "99cfed8e80ec0198756f8eadb944703aee3d7546d49db4e723465f4cb5afd9a5",
    "metrics/boundary_device_ms.decode.py":
        "5970dd61d5d8e0139790f971974d763d4504142997a2b0f09b1c52cc69566ae6",
    "metrics/call_p95_ms.py":
        "fdbed4a9a3704efc8ba97b80da764333424b67ffcd925b19f04b56133a348ad3",
    "metrics/call_p95_ms.serving_decode.py":
        "9975ef7852ea06704b03e5861e39dbcc561deb3bdeb4bc2f15f92c071de02265",
    "metrics/d2h_bytes_per_px.serving_decode.py":
        "cb49d720cacd94cd9daedea8ca01673e76a127cd89c311617e70bea7272878e6",
    "metrics/decode_mpix_s.py":
        "7b6fada7d44fe0f47a875a93c620e6be8acbdf0334d0ddc07bc934aecb3f54eb",
    "metrics/e1_roofline.py":
        "7c62d74ade3f6b43e36f5a6040e4a37bc76c89d20a5b4f94a9b74a09546a9275",
    "metrics/encode_mpix_s.py":
        "0d86c0accd22bcccacf2905e3a6af78e5def0689974d0d8cf8f19afdeb3a27ac",
    "metrics/fields_rows_per_px.encode.py":
        "4a355bff2c790f8d8f5b3a29583dff4013bc3da38e96c51a37fe7d60dd486772",
    "metrics/host_finish_ms.serving_decode.py":
        "ee20adf2a597c828d602c7e4dfd564c068d7d5802879b97142286829a05c1da4",
    "metrics/host_finish_ms.serving_encode.py":
        "764c6329dfc3c8de38550400090845312195a15cfae942a2ae7d5187cb21f483",
    "metrics/host_pack_ms.batch_decode.py":
        "89c92bd535f657643a457a21c1c49b6a6db3653626b3a4d9361d50fb9274689a",
    "metrics/host_stage_ms.serving_decode.py":
        "064452e09adb634a59f99f30d02c1a97f826284047365da8beb34d63fb1e5785",
    "metrics/host_stage_ms.serving_encode.py":
        "8ab5baaafc9b0bd3e3abb44e7876c5d13c9d61c6a5110a777feadc3a7fa9f6b6",
    "metrics/host_unpack_ms.serving_decode.py":
        "649704b2dad1e009154197eddebd4ab691180b91c77cd53ad6707bb4a8aacd81",
    "metrics/host_wait_ms.serving_decode.py":
        "99ccaf634a848946754378c6ff5bcf7ffbcf9a713bcf5d395251af4bc84038af",
    "metrics/host_wait_ms.serving_encode.py":
        "15d83ccb7b9d00c71e0c3f0ff55e0d78c47a338b0a39047db02ff34259875590",
    "metrics/idle_pct.decode.py":
        "beed1f4f279b152768e02b9acbff2767e80ff0a6dbdd0acddb63b137de70483a",
    "metrics/idle_pct.encode.py":
        "b1e4ef5a4f882c50c8d2c045b5d3b6c9785093b4ceda4635cbcd6be9f663dc43",
    "metrics/k1_roofline.py":
        "b0a29db2b4e207672c5c2dee5b9b5d6c34829586db30f1a53c5acdcc5c6c4591",
    "metrics/k2_roofline.py":
        "a2062bf49f8f0c077caca90d8644c04a969aa2920ef6d0f6c24a4d5b3f25a89e",
    "metrics/k3_roofline.py":
        "ae2b6200b68e73d65a99cd985261ff76825bff26e6edb2f3fa154ff8de1c39a3",
    "metrics/k4_roofline.py":
        "b1f278440eeca8abc6ec80f45fd669a6e6adb7269771c1b1faacd999fbfbf6f4",
    "metrics/launches_per_call.decode.py":
        "46b92c3a34066bcb0ec561a1daef1afba847cc456e08410d1a5e426a949205fe",
    "metrics/launches_per_call.encode.py":
        "82de25758582f5089b4687d1025edf2f5f4a37661f18773f6358bca3b8ae8d58",
    "metrics/setup_s.py":
        "fb23c206e0fb6da2b0a53ddbc82f82712fed7c69c9ec1344fee01e35e03984d9",
    "metrics/split_rounds_per_call.serving_decode.py":
        "fe49dcf571e776c58d64e96bc2851aa8aedb2ba79f71e3cc66fc259a42037fe4",
    "metrics/template_rows_per_px.encode.py":
        "1d376edcb1548a303b20864e04330d82bd2cc71613edd2bb296cf5036314df6b",
    "metrics/templates_device_ms.encode.py":
        "f6a76ec5c71507defbc0e9aed9c2c2fd8e2ae978b5f52a401cb9454f222e5d15",
    "metrics/torch_passes_ms.decode.py":
        "d302d9942bcbe5f0b334c20bccd4a2e80cff9aaf26a640464dd3be5d5f46d8c0",
    "metrics/torch_passes_ms.encode.py":
        "10bc8c4023b43ba5f7b82dad85e206b2696e1c42d51b3509133c89310f5ad4ff",
    "program.py":
        "501d3c96a9c531ebb9b6dab8e2ae90d7c5402195f066841ed4cd6db9218123e9",
    "readers.py":
        "f1a74b446a51ef28a89e690bb47e70679430eb48a26e115e13b911b45ac12a0a",
    "reference.py":
        "6b5402e1662fba279b0b7797bdaf986d131511bee222603e907eb71618e092a6",
    "roofline.py":
        "55008ed761585728d0a1f5bc70c3797d178e515da024d6726b7088fb8f9b3a4e",
    "run.py":
        "9bbff560ba00a86d51b515661bbf3e30a48981770d4f3521d00e61e38f99b1b8",
    "spec.py":
        "2ec79d0125bee5ce9b68ecfb88570b58de667c4b180d96da65098c13a26c5479",
    "tests/portbench_small.py":
        "b554972d5fc1859fceccf7f4aa3455a1e09a5cb844217cf673afb0bcc630fa85",
    "tests/test_portbench_arith.py":
        "f58fedce483f3205f71f0dc0b9ae00cd1ba2b4696ac1bd44e85076c09a4f62e9",
    "tests/test_portbench_card.py":
        "ab43edfa629acab3e25a28b0f787c7f34349bdb7553d25d083f5d9ef6c2fabcf",
    "tests/test_portbench_contract.py":
        "0e8542faf976f7b3f293668aaf335d9672a57b10cb6589f006bf8cf8b7ad34ea",
    "tests/test_portbench_discovery.py":
        "2336b17340b1d733dfcd688c408465bbe956e11aad852210d06f09cb98cb7708",
    "tests/test_portbench_faults.py":
        "b117cba5c34faaf6028bf8febe5719ffada684e0ed54809c61cddf7e95f52ce0",
    "tests/test_portbench_guard.py":
        "66fa9360e3da4ffce1fc6b097e1d1c5ccab5526f4902fe6574197cae15b8983e",
    "tests/test_portbench_kinds.py":
        "317a49dfb40e1fe100fce873c1ae02f59cc5d22dfa2ccc90f35a9dfdf222804d",
    "tests/test_portbench_program.py":
        "85159b66100656305f0016eb83236199d56e233f06b2ec5fd5f64e783a4298f0",
    "tests/test_portbench_reference.py":
        "fcd63c6caddc4c15fbae62cf7180bc33b671bd530dbc96cc76adbad1629e51bf",
    "trace.py":
        "612e6de9c537a0b530543df75a3117611d41fb75968db52b0f76c2028c309a6a",
    "traffic/decode_16req_calls.json":
        "36d481abf820606e405b9d0b04b076dad2ef2368d9abd9f266026826c9e4cc4f",
    "traffic/decode_b128_from_host.json":
        "c62e0a0191050ea66dd75cc82ea501afcc6010e58456f58293f3f0fec67089ef",
    "traffic/encode_16req_calls.json":
        "644cdca78338df7468e02c4d16eda7fe69d0c4d53909a350e5313cab78fa7288",
    "traffic/encode_b128_resident.json":
        "c035adb4fa0d20594927fea0d9f5a1a4720f353afeaaa2b5fa23f39086b89677",
}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_file_before_the_streaming_cells_is_unchanged(name):
    data = (HERE / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == BEFORE[name]
