"""pgx_torch.serve against pgx on the CPU, plus the serving behaviours of
tests/test_serve.py: bucketing, padding invariance, coalescing, request
validation, close, hot reload and the HTTP front end.

The trial directory is written by pgx itself (``save_config`` +
``save_checkpoint(..., full_state=False)``) and served by the port with
``device="cpu"``.  Its uint8 images must equal pgx's
``make_eval_generate(output="uint8")`` within 1 LSB, on at least 99% of
pixels exactly: both compute in f32, and only a value that lands within
float rounding of a quantization boundary may round the other way.
"""

import http.client
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax

from pgx import checkpoint as jckpt
from pgx.models import zoo as jzoo
from pgx.models.discriminator import init_discriminator
from pgx.models.generator import init_generator as j_init
from pgx.train import LegacySchedule, TrainConfig
from pgx.train.schedule import schedule_from_dict, schedule_to_dict
from pgx.train.wgan import make_eval_generate as j_make_eval_generate
from pgx_torch import checkpoint as ckpt
from pgx_torch.serve import GeneratorService, _bucket, make_http_server
from pgx_torch.utils.png import to_uint8

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def tiny_trial(tmp_path_factory):
    """A conditional mnist-family trial written by pgx, checkpoints at
    iterations 6 (step 2, fading) and 12 (step 2, final)."""
    tmp = str(tmp_path_factory.mktemp("torch_serve") / "trial")
    gcfg = jzoo.mnist_conditional_generator(z_dim=8, num_classes=3,
                                            channel=8)
    dcfg = jzoo.mnist_conditional_discriminator_wgangp(feat_dim=8,
                                                       num_classes=3)
    sched = LegacySchedule(8, 2, 1)
    jckpt.save_config(tmp, gcfg, dcfg, TrainConfig(),
                      extra={"schedule": schedule_to_dict(sched)})
    g = jax.device_get(j_init(jax.random.PRNGKey(0), gcfg))
    d = jax.device_get(init_discriminator(jax.random.PRNGKey(1), dcfg))
    for it, shift in ((6, 0.0), (12, 0.02)):
        g_it = jax.tree_util.tree_map(lambda x: x + shift, g)
        jckpt.save_checkpoint(tmp, it, {"g_ema": g_it, "d": d},
                              full_state=False)
    return tmp


def test_bucket():
    assert [_bucket(n, 64) for n in (1, 2, 3, 5, 33, 64)] == \
        [1, 2, 4, 8, 64, 64]
    assert [_bucket(n, 64) for n in (65, 100, 128, 129)] == \
        [128, 128, 128, 256]


@pytest.mark.parametrize("checkpoint", [None, 6])
def test_uint8_output_matches_pgx(tiny_trial, checkpoint):
    svc = GeneratorService(tiny_trial, checkpoint=checkpoint, max_batch=8,
                           max_wait_ms=1.0, **CPU)
    try:
        rng = np.random.RandomState(3)
        z = rng.randn(8, 8).astype(np.float32)
        labels = (np.arange(8) % 3).astype(np.int32)
        got = svc.submit(z, labels).result(timeout=60)

        cfg = jckpt.load_config(tiny_trial)
        jcfg, _, _ = jckpt.configs_from_dict(cfg)
        _, params, _, st = jckpt.load_generator_state(
            tiny_trial, schedule_from_dict(cfg["schedule"]), checkpoint)
        assert (st.step, st.fading) == (svc.state.step, svc.state.fading)
        fn = j_make_eval_generate(jcfg, step=st.step, fading=st.fading,
                                  output="uint8")
        want = np.asarray(fn(params, z, labels, np.float32(st.alpha)))
        assert got.dtype == np.uint8 and got.shape == want.shape
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.99
    finally:
        svc.close()


def test_generate_deterministic_and_shaped(tiny_trial):
    svc = GeneratorService(tiny_trial, max_batch=8, max_wait_ms=1.0, **CPU)
    try:
        a = svc.generate_images(5, seed=7)
        b = svc.generate_images(5, seed=7)
        res = svc.stats()["resolution"]
        assert a.shape == (5, res, res, 1)
        np.testing.assert_array_equal(a, b)
        c = svc.generate_images(3, labels=[0, 1, 2], seed=1)
        d = svc.generate_images(3, class_id=2, seed=1)
        assert c.shape == d.shape == (3, res, res, 1)
        assert not np.array_equal(c, d)
    finally:
        svc.close()


def test_padding_does_not_change_results(tiny_trial):
    svc = GeneratorService(tiny_trial, max_batch=4, max_wait_ms=1.0, **CPU)
    try:
        rng = np.random.RandomState(0)
        z = rng.randn(4, 8).astype(np.float32)
        labels = np.array([0, 1, 2, 0], np.int32)
        full = svc.submit(z, labels).result(timeout=60)
        part = svc.submit(z[:3], labels[:3]).result(timeout=60)
        np.testing.assert_array_equal(part, full[:3])
    finally:
        svc.close()


def test_on_device_uint8_matches_host_quantization(tiny_trial):
    svc_u8 = GeneratorService(tiny_trial, max_batch=4, max_wait_ms=1.0,
                              **CPU)
    svc_f = GeneratorService(tiny_trial, max_batch=4, max_wait_ms=1.0,
                             output="float", **CPU)
    try:
        a = svc_u8.generate_images(4, class_id=1, seed=11)
        b = svc_f.generate_images(4, class_id=1, seed=11)
        assert a.dtype == np.uint8 and b.dtype == np.float32
        np.testing.assert_array_equal(a, to_uint8(b))
    finally:
        svc_u8.close()
        svc_f.close()


def test_dynamic_batching_coalesces(tiny_trial):
    svc = GeneratorService(tiny_trial, max_batch=16, max_wait_ms=200.0,
                           **CPU)
    try:
        svc.warmup(sizes=(8,))
        base = svc.stats()
        futs = [svc.submit(np.random.RandomState(i).randn(1, 8),
                           np.array([i % 3])) for i in range(8)]
        outs = [f.result(timeout=60) for f in futs]
        assert all(o.shape[0] == 1 for o in outs)
        s = svc.stats()
        assert s["batches"] - base["batches"] < 8
        assert s["requests"] - base["requests"] == 8
        assert s["images"] - base["images"] == 8
    finally:
        svc.close()


def test_submit_validates_requests(tiny_trial):
    svc = GeneratorService(tiny_trial, max_batch=4, max_wait_ms=1.0, **CPU)
    try:
        with pytest.raises(ValueError):
            svc.submit(np.zeros((2, 8), np.float32))          # no labels
        with pytest.raises(ValueError):
            svc.generate_images(2, labels=[0])                 # wrong length
        with pytest.raises(ValueError):
            svc.generate_images(0)
        with pytest.raises(ValueError, match="z must"):
            svc.submit(np.zeros((2, 5), np.float32), np.array([0, 1]))
        with pytest.raises(ValueError, match="z must"):
            svc.submit(np.zeros((8,), np.float32), np.array([0]))
        with pytest.raises(ValueError, match="at least one"):
            svc.submit(np.zeros((0, 8), np.float32), np.zeros(0, np.int32))
        with pytest.raises(ValueError, match="labels"):
            svc.submit(np.zeros((2, 8), np.float32), np.array([0, 99]))
        out = svc.submit(np.zeros((2, 8), np.float32),
                         np.array([0, 1])).result(timeout=60)
        assert out.shape[0] == 2
    finally:
        svc.close()


def test_batcher_never_exceeds_max_batch(tiny_trial):
    svc = GeneratorService(tiny_trial, max_batch=4, max_wait_ms=150.0,
                           **CPU)
    try:
        svc.warmup(sizes=(4,))
        base = svc.stats()["batches"]
        futs = [svc.submit(np.random.RandomState(i).randn(3, 8),
                           np.array([0, 1, 2])) for i in range(2)]
        assert all(f.result(timeout=60).shape[0] == 3 for f in futs)
        assert svc.stats()["batches"] - base == 2
    finally:
        svc.close()


def test_close_and_inline_resolution(tiny_trial):
    svc = GeneratorService(tiny_trial, max_batch=4, max_wait_ms=1.0, **CPU)
    try:
        svc.warmup(sizes=(1,))
        svc._resolver.shutdown(wait=True)   # the close() race
        out = svc.submit(np.zeros((1, 8), np.float32),
                         np.array([0])).result(timeout=60)
        assert out.shape[0] == 1
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(np.zeros((1, 8), np.float32), np.array([0]))


def test_hot_reload_and_pinning(tiny_trial):
    svc = GeneratorService(tiny_trial, max_batch=4, max_wait_ms=1.0, **CPU)
    pinned = GeneratorService(tiny_trial, checkpoint=6, max_batch=4,
                              max_wait_ms=1.0, **CPU)
    path = os.path.join(tiny_trial, "checkpoint", ckpt.checkpoint_name(18,
                                                                       "g"))
    try:
        assert svc.maybe_reload() is False
        assert svc.iteration == 12 and pinned.iteration == 6
        before = svc.generate_images(2, class_id=0, seed=3)
        params = ckpt.load_params(ckpt.latest_checkpoint(tiny_trial))
        bumped = {k: v for k, v in params.items()}
        bumped["to_rgb"] = {r: {"w": p["w"] + 0.05, "b": p["b"] + 0.05}
                            for r, p in params["to_rgb"].items()}
        ckpt.save_params(path, bumped)
        assert svc.maybe_reload() is True
        assert svc.iteration == 18 and svc.stats()["reloads"] == 1
        after = svc.generate_images(2, class_id=0, seed=3)
        assert not np.array_equal(before, after)
        assert pinned.maybe_reload() is False and pinned.iteration == 6
    finally:
        os.remove(path)
        svc.close()
        pinned.close()


def test_hot_reload_under_concurrent_load(tiny_trial):
    svc = GeneratorService(tiny_trial, max_batch=8, max_wait_ms=1.0,
                           fetch_threads=2, **CPU)
    path = os.path.join(tiny_trial, "checkpoint", ckpt.checkpoint_name(24,
                                                                       "g"))
    try:
        rng = np.random.RandomState(0)
        futs = []
        for i in range(12):
            futs.append(svc.submit(rng.randn(2, 8).astype(np.float32),
                                   np.array([i % 3, (i + 1) % 3])))
            if i == 5:
                ckpt.save_params(path, ckpt.load_params(
                    ckpt.latest_checkpoint(tiny_trial)))
                assert svc.maybe_reload() is True
        assert all(f.result(timeout=60).shape[0] == 2 for f in futs)
        assert svc.iteration == 24
    finally:
        svc.close()
        os.remove(path)


def test_from_params_and_pipelined_resolution(tiny_trial):
    gcfg = ckpt.generator_config_from_dict(ckpt.load_config(tiny_trial))
    params = ckpt.load_params(ckpt.latest_checkpoint(tiny_trial, "g"))
    svc = GeneratorService.from_params(gcfg, params, step=2, max_batch=4,
                                       max_wait_ms=0.5, fetch_threads=2,
                                       **CPU)
    try:
        assert svc.maybe_reload() is False
        rng = np.random.RandomState(0)
        zs = [rng.randn(4, 8).astype(np.float32) for _ in range(6)]
        labs = [np.arange(4) % 3 for _ in range(6)]
        outs = [f.result(timeout=60) for f in
                [svc.submit(z, lab) for z, lab in zip(zs, labs)]]
        res = svc.stats()["resolution"]
        assert all(o.shape == (4, res, res, 1) for o in outs)
        again = svc.submit(zs[2], labs[2]).result(timeout=60)
        np.testing.assert_array_equal(again, outs[2])
        assert svc.stats()["batches"] >= 6
    finally:
        svc.close()


def test_warmup_all_buckets(tiny_trial):
    svc = GeneratorService(tiny_trial, max_batch=8, max_wait_ms=0.5, **CPU)
    try:
        base = svc.stats()["batches"]
        svc.warmup("all")               # buckets 1, 2, 4, 8
        assert svc.stats()["batches"] - base == 4
    finally:
        svc.close()


def test_unported_and_unavailable_devices_raise(tiny_trial):
    """data_parallel beyond the devices of the service's type raises pgx's
    ValueError (the CPU is one device; the split itself is in
    tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match="data_parallel=2 but only 1"):
        GeneratorService(tiny_trial, data_parallel=2, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GeneratorService(tiny_trial)       # default device is cuda


@pytest.fixture()
def http_service(tiny_trial):
    svc = GeneratorService(tiny_trial, max_batch=8, max_wait_ms=1.0, **CPU)
    server = make_http_server(svc, "127.0.0.1", 0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield server.server_port, svc
    server.shutdown()
    server.server_close()
    svc.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, r.getheader("Content-Type"), body


def test_http_endpoints(http_service):
    port, svc = http_service
    status, _, body = _get(port, "/healthz")
    health = json.loads(body)
    assert status == 200 and health["ok"] and health["resolution"] == 16

    status, ctype, body = _get(port, "/generate?num=4&seed=0&class=1")
    assert status == 200 and ctype == "image/png"
    assert body.startswith(b"\x89PNG\r\n\x1a\n")

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate",
                 json.dumps({"num": 3, "labels": [0, 1, 2], "seed": 5,
                             "format": "npz"}),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 200
    with np.load(io.BytesIO(r.read())) as npz:
        assert npz["images"].shape == (3, 16, 16, 1)
        np.testing.assert_array_equal(npz["labels"], [0, 1, 2])
    conn.close()

    status, _, body = _get(port, "/generate?num=4&class=2&format=npz")
    with np.load(io.BytesIO(body)) as npz:
        np.testing.assert_array_equal(npz["labels"], [2, 2, 2, 2])

    s = json.loads(_get(port, "/stats")[2])
    assert s["requests"] >= 2 and s["images"] >= 7
    status, _, body = _get(port, "/generate?num=0")
    assert status == 400 and b"error" in body
    assert _get(port, "/nope")[0] == 404


def test_http_bad_inputs_return_400(http_service):
    port, _ = http_service
    for path in ("/generate?num=2&nrow=abc", "/generate?num=2&nrow=0",
                 "/generate?num=2&format=bmp",
                 "/generate?num=2&seed=notanint", "/generate?num=notanint"):
        status, _, body = _get(port, path)
        assert status == 400 and b"error" in body, path
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate", json.dumps([1, 2]),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    body = r.read()
    conn.close()
    assert r.status == 400 and b"error" in body


def test_http_concurrent_requests_batch(http_service):
    port, svc = http_service
    base = svc.stats()
    errs = []

    def hit(i):
        try:
            status, _, body = _get(port, f"/generate?num=1&seed={i}")
            assert status == 200 and body.startswith(b"\x89PNG")
        except Exception as e:    # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs and not any(t.is_alive() for t in threads)
    s = svc.stats()
    assert s["requests"] - base["requests"] == 6
    assert s["batches"] - base["batches"] <= 6
