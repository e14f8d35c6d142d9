"""The port's host utilities against pgx's, on the CPU.

``pgx_torch.utils`` (``EasyDict``, ``Logger``, ``trace.span`` as pgx's
``profiled``, ``format_time``, ``format_size``, ``get_obj_by_name``,
``call_func_by_name``, ``list_dir_recursively_with_ignore``),
``pgx_torch.utils.misc`` (``constant``, ``assert_shape``,
``InfiniteSampler``, ``named_leaves``, ``copy_params``,
``print_param_summary``), ``pgx_torch.utils.url`` (local paths and
``file://`` URLs only: no network) and ``pgx_torch.utils.persistence``
(``restore_from_snapshot``, ``verify_snapshot`` on a port snapshot).  Where
pgx has the same function, both get the same inputs and must give the same
result exactly.
"""

import itertools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import pgx.utils as jutils
from pgx.models import init_generator as jinit_generator
from pgx.models import zoo as jzoo
from pgx.utils import misc as jmisc
from pgx.utils import url as jurl
import pgx_torch.utils as tutils
from pgx_torch.models import zoo as tzoo
from pgx_torch.models.generator import Generator
from pgx_torch.utils import misc as tmisc
from pgx_torch.utils import persistence, trace
from pgx_torch.utils import url as turl


@pytest.mark.parametrize("size,rank,replicas,shuffle,window", [
    (17, 0, 1, True, 0.5), (17, 1, 3, True, 0.5), (40, 2, 4, True, 0.0),
    (9, 0, 2, False, 0.5), (33, 3, 4, True, 1.0)])
def test_infinite_sampler_matches_pgx(size, rank, replicas, shuffle, window):
    kw = dict(rank=rank, num_replicas=replicas, shuffle=shuffle, seed=5,
              window_size=window)
    take = lambda s: list(itertools.islice(iter(s), 300))
    assert take(tmisc.InfiniteSampler(size, **kw)) == take(
        jmisc.InfiniteSampler(size, **kw))


def test_infinite_sampler_refuses_bad_arguments():
    for kw in (dict(rank=2, num_replicas=2), dict(window_size=1.5)):
        with pytest.raises(ValueError):
            tmisc.InfiniteSampler(5, **kw)


def test_list_dir_recursively_with_ignore_matches_pgx(tmp_path):
    for rel in ("a.py", "b.txt", "sub/c.py", "sub/__pycache__/c.pyc",
                "sub/deep/d.py", "skip/e.py", "f.pyc"):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(rel)
    for ignores in (None, ["__pycache__", "*.pyc"], ["skip", "*.txt"]):
        assert tutils.list_dir_recursively_with_ignore(
            str(tmp_path), ignores) == jutils.list_dir_recursively_with_ignore(
            str(tmp_path), ignores)


def test_format_time_and_size_match_pgx():
    for s in (0, 0.4, 59.6, 61, 3599, 3600, 86399, 86400, 200000.7):
        assert tutils.format_time(s) == jutils.format_time(s)
    for n in (0, 1, 1023, 1024, 1536, 10 ** 6, 3 * 1024 ** 3, 1024 ** 5):
        assert tutils.format_size(n) == jutils.format_size(n)


def test_easydict_logger_and_reflection(tmp_path, capsys):
    d = tutils.EasyDict(a=1)
    d.b = 2
    assert d == {"a": 1, "b": 2} and d.a == 1
    del d.a
    with pytest.raises(AttributeError):
        d.a
    log = tutils.Logger(str(tmp_path / "log.txt"), mode="w")
    print("tee")
    log.close()
    assert (tmp_path / "log.txt").read_text() == "tee\n"
    assert "tee" in capsys.readouterr().out
    assert tutils.get_obj_by_name("os.path.join") is \
        jutils.get_obj_by_name("os.path.join") is os.path.join
    assert tutils.get_obj_by_name(
        "pgx_torch.utils.misc.InfiniteSampler") is tmisc.InfiniteSampler
    assert tutils.call_func_by_name("os.path.join", "a", "b") == \
        jutils.call_func_by_name("os.path.join", "a", "b")
    with pytest.raises(ImportError):
        tutils.get_obj_by_name("no_such_module.thing")


def test_profiled_names_a_span(monkeypatch):
    """pgx's ``profiled`` is ``trace.span``'s decorator form: the span is
    named in a CPU profiler's operators, and with no profiler active no
    ``record_function`` is entered, recording or not."""
    @trace.span("pgx_span")
    def work(x):
        return x * 2

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert torch.equal(work(torch.ones(3)), torch.full((3,), 2.0))
    assert "pgx_span" in {e.key for e in prof.key_averages()}
    assert work.__name__ == "work"
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a) or real(*a, **k))
    trace.clear()
    try:
        for on in (False, True):
            if on:
                trace.enable()
            assert torch.equal(work(torch.ones(3)), torch.full((3,), 2.0))
    finally:
        trace.disable()
    assert entered == []
    assert [s["name"] for s in trace.spans()] == ["pgx_span"]
    trace.clear()


def test_constant_and_assert_shape():
    a = tmisc.constant([1.0, 2.0], shape=(3, 2), dtype=torch.float32)
    assert a is tmisc.constant([1.0, 2.0], shape=(3, 2), dtype=torch.float32)
    assert a is not tmisc.constant([1.0, 2.0], shape=(3, 2),
                                   dtype=torch.float64)
    assert a is not tmisc.constant([1.0, 3.0], shape=(3, 2),
                                   dtype=torch.float32)
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(jmisc.constant([1.0, 2.0], shape=(3, 2),
                                             dtype=np.float32)))
    x = torch.zeros(2, 3, 4)
    tmisc.assert_shape(x, [2, None, 4])
    for ref in ([2, 3], [2, 5, 4]):
        with pytest.raises(AssertionError) as tgot:
            tmisc.assert_shape(x, ref)
        with pytest.raises(AssertionError) as jgot:
            jmisc.assert_shape(np.zeros((2, 3, 4)), ref)
        assert str(tgot.value) == str(jgot.value)


def _params():
    """pgx's seeded tree of a tiny generator, and the port's module of the
    same weights."""
    jcfg = jzoo.conditional_correct_generator(z_dim=8, num_classes=3,
                                              channel=16, max_step=3)
    tree = jax.device_get(jinit_generator(jax.random.PRNGKey(0), jcfg))
    tcfg = tzoo.conditional_correct_generator(z_dim=8, num_classes=3,
                                              channel=16, max_step=3)
    return tree, Generator.from_jax_params(tcfg, tree, "cpu")


def test_param_summary_and_named_leaves_match_pgx(capsys):
    tree, module = _params()
    want = jmisc.print_param_summary(tree, "G")
    for params in (module, module.state_dict(), tree):
        assert tmisc.print_param_summary(params, "G") == want
    assert capsys.readouterr().out.count("G:") == 4
    jnames = jmisc.named_leaves(tree)
    tnames = tmisc.named_leaves(module)
    assert list(tnames) == list(jnames)
    for k in jnames:
        np.testing.assert_array_equal(tnames[k].numpy(), jnames[k])


def test_copy_params_matches_pgx():
    tree, module = _params()
    rng = np.random.RandomState(0)
    src = jax.tree.map(lambda a: rng.randn(*a.shape).astype(a.dtype), tree)
    src_part = {"blocks": src["blocks"]}
    want = jmisc.copy_params(src_part, tree, require_all=False)
    got = tmisc.copy_params(src_part, tree, require_all=False)
    assert tmisc.named_leaves(got).keys() == jmisc.named_leaves(want).keys()
    for k, v in jmisc.named_leaves(want).items():
        np.testing.assert_array_equal(tmisc.named_leaves(got)[k], v)
    with pytest.raises(KeyError):
        tmisc.copy_params(src_part, tree)
    # a state_dict keeps its dotted names; loading it writes the module
    sd = tmisc.copy_params(src, module.state_dict())
    assert list(sd) == list(module.state_dict())
    module.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    for k, v in tmisc.named_leaves(module).items():
        np.testing.assert_array_equal(v.numpy(), tmisc.named_leaves(src)[k])


def test_open_url_on_local_paths_matches_pgx(tmp_path):
    path = tmp_path / "blob.bin"
    path.write_bytes(b"\x00pgx\xff" * 10)
    uri = pathlib.Path(path).as_uri()
    for target in (str(path), uri):
        with turl.open_url(target) as f, jurl.open_url(target) as g:
            assert f.read() == g.read() == path.read_bytes()
        assert turl.open_url(target, return_filename=True) == \
            jurl.open_url(target, return_filename=True) == str(path)
    for s in ("https://example.com/a.pkl", "http://x", uri, str(path),
              "ftp://example.com/a", "https://", 3):
        for allow in (False, True):
            assert turl.is_url(s, allow_file_urls=allow) == jurl.is_url(
                s, allow_file_urls=allow), (s, allow)
    assert tutils.open_url is turl.open_url


def test_snapshot_restores_and_verifies(tmp_path):
    trial = str(tmp_path / "trial")
    persistence.snapshot_sources(trial)
    assert persistence.verify_snapshot(trial) == {}
    root = persistence.restore_from_snapshot(trial, str(tmp_path / "src"))
    code = "import pgx_torch.utils.misc as m, json; print(json.dumps(m.__file__))"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=root),
                         cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout).startswith(root)
    snap = os.path.join(trial, "src_snapshot")
    with open(os.path.join(snap, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert "utils/misc.py" in manifest and "ops/kernels/csrc/epilogue.cu" in \
        manifest
    # drift against the package imported now
    drifted = dict(manifest, **{"utils/misc.py": "0" * 64,
                                "gone.py": manifest["utils/misc.py"]})
    with open(os.path.join(snap, "MANIFEST.json"), "w") as f:
        json.dump(drifted, f)
    assert persistence.verify_snapshot(trial) == {
        "utils/misc.py": "changed", "gone.py": "missing"}
    with open(os.path.join(snap, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    # tampering with the snapshot itself refuses the restore
    with open(os.path.join(snap, "pgx_torch", "utils", "misc.py"), "a") as f:
        f.write("# edited\n")
    with open(os.path.join(snap, "pgx_torch", "planted.py"), "w") as f:
        f.write("x = 1\n")
    with pytest.raises(ValueError, match="corrupt") as err:
        persistence.restore_from_snapshot(trial, str(tmp_path / "src2"))
    assert "unlisted" in str(err.value) and "planted.py" in str(err.value)
    assert not os.path.exists(tmp_path / "src2")
    assert persistence.restore_from_snapshot(
        trial, str(tmp_path / "src3"), verify=False)
