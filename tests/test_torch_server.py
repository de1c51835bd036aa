"""PyTorch port, the HTTP serving front end (the port's ``server.py`` and
``tools/serve_http.py``): the cases of tests/test_server.py against the
port's server over the port's Transcriber on the CPU: the API contract,
parity with the underlying Transcriber and, on one experiment folder, with
the JAX package's server."""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import jax
import torch

from attention_based_e2e_asr_dnn_tpu import constants
from attention_based_e2e_asr_dnn_tpu.models.las import (
    LASConfig,
    ListenerConfig,
    SpellerConfig,
    las_init,
)
from attention_based_e2e_asr_dnn_tpu.server import AsrHttpServer as JaxAsrHttpServer
from attention_based_e2e_asr_dnn_tpu.serving import Transcriber as JaxTranscriber
from attention_based_e2e_asr_dnn_tpu.training.checkpoints import (
    save_checkpoint,
)
from attention_based_e2e_asr_dnn_tpu_torch.server import AsrHttpServer
from attention_based_e2e_asr_dnn_tpu_torch.serving import Transcriber
from attention_based_e2e_asr_dnn_tpu_torch.tools import serve_http as cli

torch.set_num_threads(1)

CFG = LASConfig(
    listener=ListenerConfig(input_dim=15, uniform_hid_dim=16, lstm_layers=1,
                            plstm_layers=1),
    speller=SpellerConfig(enc_out_dim=32, att_proj_dim=8, att_heads=1,
                          dec_emb_dim=16, dec_lstm_hid_dim=16,
                          dec_lstm_out_dim=8, CHR_MAX_STEPS=12),
)


def _make_experiment(root):
    os.makedirs(os.path.join(root, "ckpts"))
    snap = {
        "compute_dtype": "float32",
        "VOCAB": list(constants.VOCAB),
        "SOS_IDX": constants.SOS_IDX,
        "EOS_IDX": constants.EOS_IDX,
        "model": {"configs": {
            "listener_configs": {
                "input_dim": 15, "uniform_hid_dim": 16, "lstm_layers": 1,
                "plstm_layers": 1, "bidirectional": True,
                "init_dropout": 0.0, "mid_dropout": 0.0,
                "final_dropout": 0.0},
            "speller_configs": {
                "att_proj_dim": 8, "att_heads": 1, "att_dropout": 0.0,
                "dec_emb_dim": 16, "dec_emb_dropout": 0.0,
                "dec_lstm_hid_dim": 16, "dec_lstm_out_dim": 8,
                "dec_lstm_dropout": 0.0, "CHR_MAX_STEPS": 12,
                "CHR_PAD_IDX": constants.PAD_IDX,
                "CHR_SOS_IDX": constants.SOS_IDX, "USE_GREEDY": True},
        }},
    }
    with open(os.path.join(root, "config.json"), "w") as fh:
        json.dump(snap, fh)
    save_checkpoint(os.path.join(root, "ckpts",
                                 "min-loss-ld-ppl-epoch[1].ckpt"),
                    {"params": las_init(jax.random.PRNGKey(0), CFG),
                     "epoch": 1})
    return root


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload, raw: bytes = None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def http_server(tmp_path_factory):
    run_dir = _make_experiment(str(tmp_path_factory.mktemp("exp") / "run"))
    t = Transcriber(run_dir, batch_size=4, pad_time_multiple=16, device="cpu")
    server = AsrHttpServer(t, port=0, max_wait_ms=5.0).start()
    server.run_dir = run_dir
    yield server, t
    server.close()


def test_health_ready_meta(http_server):
    server, t = http_server
    base = f"http://127.0.0.1:{server.port}"
    assert _get(f"{base}/healthz") == (200, {"ok": True})
    code, body = _get(f"{base}/readyz")
    assert code == 200 and body["ready"]  # no warmup ladder -> always ready
    code, meta = _get(f"{base}/v1/meta")
    assert code == 200
    assert meta["input_dim"] == 15 and meta["batch_size"] == 4
    assert meta["corrector"] is False
    assert _get(f"{base}/nope")[0] == 404


def test_transcribe_single_and_batch_match_direct(http_server):
    server, t = http_server
    base = f"http://127.0.0.1:{server.port}"
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((n, 15)).astype(np.float32)
             for n in (20, 9, 14)]
    want = t.transcribe(feats)

    code, body = _post(f"{base}/v1/transcribe",
                       {"features": feats[0].tolist()})
    assert code == 200 and body["transcript"] == want[0]

    code, body = _post(f"{base}/v1/transcribe", {
        "instances": [{"features": f.tolist()} for f in feats]})
    assert code == 200 and body["transcripts"] == want


def test_features_b64_wire_format(http_server):
    """base64 float32 payloads decode to the same transcripts as the JSON
    list form; malformed/ragged payloads 400."""
    import base64

    server, t = http_server
    url = f"http://127.0.0.1:{server.port}/v1/transcribe"
    rng = np.random.default_rng(3)
    f = rng.standard_normal((17, 15)).astype(np.float32)
    _, want = _post(url, {"features": f.tolist()})
    b64 = base64.b64encode(f.astype("<f4").tobytes()).decode()
    code, got = _post(url, {"features_b64": b64})
    assert code == 200 and got == want
    code, got = _post(url, {"instances": [{"features_b64": b64},
                                          {"features": f.tolist()}]})
    assert code == 200 and got["transcripts"] == [want["transcript"]] * 2

    assert _post(url, {"features_b64": "!!!not-base64!!!"})[0] == 400
    ragged = base64.b64encode(b"\x00" * 61).decode()  # not /60
    code, body = _post(url, {"features_b64": ragged})
    assert code == 400 and "float32" in body["error"]


def test_concurrent_posts_are_batched_and_ordered(http_server):
    server, t = http_server
    base = f"http://127.0.0.1:{server.port}"
    rng = np.random.default_rng(1)
    feats = [rng.standard_normal((10 + i, 15)).astype(np.float32)
             for i in range(6)]
    want = t.transcribe(feats)

    import threading

    results = [None] * len(feats)

    def hit(i):
        _, body = _post(f"{base}/v1/transcribe",
                        {"features": feats[i].tolist()})
        results[i] = body["transcript"]

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(feats))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert results == want


def test_error_statuses(http_server):
    server, _ = http_server
    base = f"http://127.0.0.1:{server.port}"
    url = f"{base}/v1/transcribe"
    assert _post(url, None, raw=b"{not json")[0] == 400
    assert _post(url, {"nope": 1})[0] == 400
    code, body = _post(url, {"features": [[1.0] * 14] * 5})
    assert code == 400 and "input_dim" in body["error"]
    assert _post(url, {"features": [1.0, 2.0]})[0] == 400
    assert _post(url, {"instances": []})[0] == 400
    code, _ = _post(url, {"instances": [
        {"features": [[0.0] * 15] * 2}] * 257})
    assert code == 413
    assert _post(f"{base}/other", {})[0] == 404


def test_metrics_endpoint(http_server):
    """Prometheus exposition: request counts by status, utterance totals,
    latency histogram invariants."""
    server, t = http_server
    base = f"http://127.0.0.1:{server.port}"
    rng = np.random.default_rng(7)
    _post(f"{base}/v1/transcribe", {"instances": [
        {"features": rng.standard_normal((8, 15)).tolist()}
        for _ in range(3)]})
    _post(f"{base}/v1/transcribe", {"nope": 1})  # a 400

    import urllib.request
    with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
    lines = dict()
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            k, v = ln.rsplit(" ", 1)
            lines[k] = float(v)
    assert lines['asr_requests_total{status="200"}'] >= 1
    assert lines['asr_requests_total{status="400"}'] >= 1
    assert lines["asr_utterances_total"] >= 3
    assert lines["asr_request_seconds_count"] >= 2
    assert lines["asr_request_seconds_sum"] > 0
    assert (lines['asr_request_seconds_bucket{le="+Inf"}']
            == lines["asr_request_seconds_count"])
    assert lines["asr_in_flight"] == 0


def test_body_size_cap(http_server):
    server, _ = http_server
    url = f"http://127.0.0.1:{server.port}/v1/transcribe"
    old = server.max_body_bytes
    server.max_body_bytes = 64
    try:
        code, body = _post(url, {"features": [[0.0] * 15] * 20})
        assert code == 413 and "limit 64" in body["error"]
    finally:
        server.max_body_bytes = old


def test_http_serving_matches_jax_server_and_frame_cap(http_server):
    """The same experiment folder behind both packages' servers gives the
    same transcripts and metadata (artifact serving is not ported: a
    transcriber that reports a hard frame cap, as the JAX package's artifact
    one does, still has it enforced before batching)."""
    server, t = http_server
    jt = JaxTranscriber(server.run_dir, batch_size=4, pad_time_multiple=16)
    jserver = JaxAsrHttpServer(jt, port=0, max_wait_ms=5.0).start()
    try:
        rng = np.random.default_rng(2)
        feats = [rng.standard_normal((n, 15)).astype(np.float32)
                 for n in (20, 9)]
        body = {"instances": [{"features": f.tolist()} for f in feats]}
        ours = _post(f"http://127.0.0.1:{server.port}/v1/transcribe", body)
        theirs = _post(f"http://127.0.0.1:{jserver.port}/v1/transcribe", body)
        assert ours == theirs and ours[0] == 200
        assert (_get(f"http://127.0.0.1:{server.port}/v1/meta")
                == _get(f"http://127.0.0.1:{jserver.port}/v1/meta"))
    finally:
        jserver.close()
    t.max_frames, t.bucket_t_pads = 32, [32]
    try:
        base = f"http://127.0.0.1:{server.port}"
        code, meta = _get(f"{base}/v1/meta")
        assert meta["max_frames"] == 32 and meta["buckets"] == [32]
        # over-capacity requests 400 BEFORE batching (a raise inside the
        # shared batch would 500 innocent co-batched requests)
        code, body = _post(f"{base}/v1/transcribe",
                           {"features": [[0.0] * 15] * 40})
        assert code == 400 and "capacity" in body["error"]
    finally:
        del t.max_frames, t.bucket_t_pads


def test_negative_content_length_rejected(http_server):
    """A negative Content-Length must 400 immediately — read(-1) would
    block the handler thread until the client hangs up (DoS)."""
    import http.client

    server, _ = http_server
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=15)
    try:
        conn.putrequest("POST", "/v1/transcribe")
        conn.putheader("Content-Length", "-1")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert b"Content-Length" in resp.read()
    finally:
        conn.close()


def test_readyz_surfaces_warmup_failure(http_server):
    """A dead background warmup must yield a 503 JSON body, not a dropped
    connection."""
    server, t = http_server
    base = f"http://127.0.0.1:{server.port}"
    orig = t.wait_ready
    t.wait_ready = lambda timeout=None: (_ for _ in ()).throw(
        RuntimeError("background auto-warmup failed"))
    try:
        code, body = _get(f"{base}/readyz")
        assert code == 503
        assert body["ready"] is False and "auto-warmup" in body["error"]
    finally:
        t.wait_ready = orig


def test_readyz_gates_on_auto_warmup(http_server):
    """With a warm-up ladder /readyz is 503 until the largest bucket has run
    and 200 afterwards."""
    import threading

    server, _ = http_server
    gate = threading.Event()

    class Slow(Transcriber):
        def _decode(self, x, lx):
            gate.wait(60)
            return super()._decode(x, lx)

    t = Slow(server.run_dir, batch_size=4, pad_time_multiple=16, device="cpu",
             auto_warmup=(32,))
    slow = AsrHttpServer(t, port=0, max_wait_ms=5.0).start()
    try:
        base = f"http://127.0.0.1:{slow.port}"
        assert _get(f"{base}/healthz") == (200, {"ok": True})
        assert _get(f"{base}/readyz") == (503, {"ready": False})
        gate.set()
        assert t.wait_ready(timeout=60)
        assert _get(f"{base}/readyz") == (200, {"ready": True})
    finally:
        gate.set()
        slow.close()


@pytest.mark.parametrize("flags,item", [
    (["--data-parallel", "2"], "data_parallel=2 but only 1 devices visible"),
])
def test_serve_http_names_the_roadmap_item_of_unported_flags(http_server, flags, item):
    """The JAX tool's flags parse and reach the Transcriber: ``--data-parallel
    2`` splits each batch over two devices, which the CPU is not (the split
    itself: tests/test_torch_dp_cli.py); in ``--artifact`` mode, where the
    split is fixed at export, the flag is refused as the JAX tool refuses it."""
    server, _ = http_server
    with pytest.raises(ValueError, match=item):
        cli.main([server.run_dir, "--device", "cpu", "--port", "0", *flags])
    with pytest.raises(SystemExit):
        cli.main(["--artifact", "x.tlas", "--device", "cpu", *flags])


@pytest.mark.parametrize("flags", [["--corrector-span-family", "f90"],
                                   ["--corrector-margin", "0.2"]])
def test_serve_http_refuses_corrector_flags_without_a_corrector(tmp_path, flags):
    """As the JAX tool: these flags without ``--corrector`` would serve no
    correction at all, so the parser refuses them."""
    with pytest.raises(SystemExit):
        cli.main([str(tmp_path), "--device", "cpu", *flags])


@pytest.mark.parametrize("flags", [["--beam-size", "4"], ["--corrector", "LM"],
                                   ["--corrector", "LM", "--corrector-span-family", "conf",
                                    "--corrector-margin", "-0.5"]],
                         ids=["beam", "corrector", "corrector-span"])
def test_serve_http_serves_beam_and_corrected_text(http_server, tmp_path, flags):
    """``--beam-size`` and ``--corrector`` (with its flags) reach the
    Transcriber: a POST returns what a Transcriber built with the same
    options, beam search or the gated Rewriter, transcribes directly."""
    from test_torch_lminfer import make_lm_experiment

    from attention_based_e2e_asr_dnn_tpu_torch.serving import Corrector, Transcriber

    server, _ = http_server
    lm = make_lm_experiment(str(tmp_path / "lm")) if "LM" in flags else None
    flags = [lm if f == "LM" else f for f in flags]
    args = cli.build_argparser().parse_args(
        [server.run_dir, "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--batch-size", "4", "--pad-time-multiple", "16", *flags])
    t2, srv = cli.start(args)
    try:
        corrector = None
        if lm is not None:
            assert t2.corrector is not None
            span = args.corrector_span_family
            corrector = Corrector(lm, confidence_margin=args.corrector_margin,
                                  span_rewrite=span is not None, span_family=span or "best",
                                  device="cpu")
        direct = Transcriber(server.run_dir, batch_size=4, pad_time_multiple=16,
                             beam_size=args.beam_size, corrector=corrector, device="cpu")
        feats = [np.random.default_rng(i).standard_normal((12 + 5 * i, 15)).astype(np.float32)
                 for i in range(3)]
        code, body = _post(f"http://127.0.0.1:{srv.port}/v1/transcribe",
                           {"instances": [{"features": f.tolist()} for f in feats]})
        assert code == 200 and body["transcripts"] == direct.transcribe(feats)
    finally:
        srv.close()


def test_serve_http_starts_a_server_on_the_cpu(http_server):
    server, t = http_server
    args = cli.build_argparser().parse_args(
        [server.run_dir, "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--batch-size", "4", "--pad-time-multiple", "16", "--warmup", "16", "32"])
    t2, srv = cli.start(args)
    try:
        assert t2.wait_ready(timeout=120) and (t2.batch_size, t2._ready_bucket) == (4, 32)
        f = np.random.default_rng(5).standard_normal((12, 15)).astype(np.float32)
        code, body = _post(f"http://127.0.0.1:{srv.port}/v1/transcribe",
                           {"features": f.tolist()})
        assert code == 200 and body["transcript"] == t.transcribe([f])[0]
    finally:
        srv.close()
    with pytest.raises(SystemExit):
        cli.main([server.run_dir, "--device", "cpu", "--warmup"])
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([server.run_dir])
