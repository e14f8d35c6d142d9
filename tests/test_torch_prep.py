"""pgx_torch's host-side data preparation against pgx's: the Haar cascade
engine, the template face detector, the crops, the metadata / rename /
unload tools and the ``prepare_data`` CLI, on the synthetic faces and noise
of tests/test_face_detection.py.  Boxes, points and output bytes are exact.

Also: the port's cascade file is a byte-identical copy of pgx's, and no
module of pgx_torch (nor chip_smoke.py) imports jax, pgx or
__graft_entry__, or opens a file under pgx/.
"""

import ast
import hashlib
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from pgx.data import face_detect as jface
from pgx.data import haar as jhaar
from pgx.data import prep as jprep
from pgx_torch.data import face_detect as tface
from pgx_torch.data import haar as thaar
from pgx_torch.data import prep as tprep
from tests.test_face_detection import synth_face

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMAGES = {
    "centered": lambda: synth_face(160, 160, 80, 80, 80),
    "off_center": lambda: synth_face(140, 220, 160, 70, 60),
    "wide": lambda: synth_face(120, 260, 195, 60, 70),
    "noise": lambda: np.random.RandomState(0).randint(
        0, 255, (160, 160, 3)).astype(np.uint8),
    "flat": lambda: np.full((100, 120, 3), 90, np.uint8),
}


def test_cascade_is_a_byte_identical_copy():
    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    assert os.path.dirname(thaar.FRONTALFACE_PATH) == os.path.join(
        REPO, "pgx_torch", "data", "cascades")
    assert sha(thaar.FRONTALFACE_PATH) == sha(jhaar.FRONTALFACE_PATH)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_detectors_match_pgx(name):
    img = IMAGES[name]()
    faces = thaar.detect_faces(img)
    assert faces == jhaar.detect_faces(img)
    point = tface.detect_face(img)
    assert point == jface.detect_face(img)
    if name in ("centered", "off_center", "wide"):
        assert faces and point is not None


def test_group_rectangles_matches_pgx():
    rng = np.random.RandomState(1)
    boxes = [tuple(float(v) for v in b) for b in np.concatenate([
        rng.normal((10, 10, 50, 50), 1.5, (5, 4)),
        rng.normal((200, 200, 40, 40), 1.0, (2, 4)),
        rng.normal((90, 20, 30, 30), 1.0, (3, 4))])]
    for k in (1, 2, 3, 4):
        assert thaar.group_rectangles(boxes, k) == \
            jhaar.group_rectangles(boxes, k)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_crops_match_pgx(name):
    img = IMAGES[name]()
    np.testing.assert_array_equal(tprep.cut_to_square(img),
                                  jprep.cut_to_square(img))
    h, w = img.shape[:2]
    for cx, cy in ((0, 0), (w // 3, h // 2), (w, h)):
        np.testing.assert_array_equal(tprep.cut_based_on_point(img, cx, cy),
                                      jprep.cut_based_on_point(img, cx, cy))
    for det in (tface.detect_face, lambda im: None):
        np.testing.assert_array_equal(tprep.cut_face(img, detector=det),
                                      jprep.cut_face(img, detector=det))


def test_default_detector_chain_matches_pgx():
    """Both chains resolve to the same leg here and crop alike."""
    tprep.default_face_detector.cache_clear()
    jprep.default_face_detector.cache_clear()
    try:
        tdet, jdet = tprep.default_face_detector(), jprep.default_face_detector()
        assert (tdet.__module__.replace("pgx_torch.", "pgx.")
                == jdet.__module__) and tdet.__name__ == jdet.__name__
        img = IMAGES["wide"]()
        np.testing.assert_array_equal(tprep.cut_face(img),
                                      jprep.cut_face(img))
    finally:
        tprep.default_face_detector.cache_clear()
        jprep.default_face_detector.cache_clear()


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _dataset(root):
    """Two categories with names to sanitize, a nested folder, a non-image
    file and images of several sizes."""
    from PIL import Image
    rng = np.random.RandomState(2)
    for cat, sizes in (("a", ((20, 24), (40, 32))), ("b&c", ((36, 36),))):
        os.makedirs(os.path.join(root, cat), exist_ok=True)
        for i, (w, h) in enumerate(sizes):
            Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(
                np.uint8)).save(os.path.join(root, cat, f"x&y#{i}.png"))
    with open(os.path.join(root, "a", "notes.txt"), "w") as f:
        f.write("not an image")
    Image.new("RGB", (8, 8), (255, 0, 0)).save(os.path.join(root, "a",
                                                            "x&y#0?.png"))


def test_metadata_rename_unload_match_pgx(tmp_path):
    for pkg, prep in (("jax", jprep), ("port", tprep)):
        root = tmp_path / pkg / "imgs"
        _dataset(str(root))
        assert prep.rename_images(str(root)) == 4
        assert prep.create_metadata(str(root),
                                    str(tmp_path / pkg / "info.csv")) == 4
        arch = tmp_path / pkg / "arch"
        os.makedirs(arch)
        for k in range(2):
            with zipfile.ZipFile(arch / f"ckpt{k}.zip", "w") as zf:
                zf.writestr(f"run/{k}/01{k}_g.model", bytes([k] * 7))
                zf.writestr(f"run/{k}/log.txt", b"junk")
                zf.writestr("run/dir/", b"")
        assert prep.unload_checkpoints(str(arch), str(tmp_path / pkg /
                                                      "out")) == 2
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_prepare_data_cli_matches_pgx(tmp_path, capsys):
    """``square`` and ``facecrop`` (the default detector chain, and
    ``--points-csv``) over a nested folder write the same files, byte for
    byte, and print the same counts; ``metadata``, ``rename`` and
    ``unload`` likewise."""
    from PIL import Image

    from pgx.cli.prepare_data import main as jmain
    from pgx_torch.cli.prepare_data import main as tmain
    src = tmp_path / "src"
    os.makedirs(src / "sub")
    Image.fromarray(IMAGES["wide"]()).save(src / "face.png")
    Image.fromarray(IMAGES["off_center"]()).save(src / "sub" / "face.png")
    Image.fromarray(IMAGES["flat"]()).save(src / "blank.png")
    Image.fromarray(IMAGES["noise"]()[:, :100]).save(src / "sub" / "n.jpg")
    points = tmp_path / "points.csv"
    points.write_text("filename,cx,cy\nblank.png,10,20\nsub/n.jpg,90.5,3\n")
    os.makedirs(tmp_path / "arch")
    with zipfile.ZipFile(tmp_path / "arch" / "c.zip", "w") as zf:
        zf.writestr("r/005_d.model", b"d")
        zf.writestr("r/readme", b"x")
    printed = {}
    for pkg, main in (("jax", jmain), ("port", tmain)):
        out = tmp_path / pkg
        tprep.default_face_detector.cache_clear()
        jprep.default_face_detector.cache_clear()
        main(["square", "--src", str(src), "--dst", str(out / "square")])
        main(["facecrop", "--src", str(src), "--dst", str(out / "face")])
        main(["facecrop", "--src", str(src), "--dst", str(out / "points"),
              "--points-csv", str(points)])
        main(["metadata", "--root", str(out / "square"), "--out",
              str(out / "info.csv")])
        _dataset(str(out / "renamed"))
        main(["rename", "--root", str(out / "renamed")])
        main(["unload", "--archives", str(tmp_path / "arch"), "--out",
              str(out / "unloaded")])
        printed[pkg] = capsys.readouterr().out.replace(str(out), "OUT")
    tprep.default_face_detector.cache_clear()
    jprep.default_face_detector.cache_clear()
    assert printed["port"] == printed["jax"]
    assert "cropped 4 images" in printed["port"]
    assert "cropped 2 images (2 skipped" in printed["port"]
    assert "renamed 4 files" in printed["port"]
    assert "extracted 1 model files" in printed["port"]
    port, jax_ = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port == jax_
    assert {"face/face.png", "face/sub/face.png", "points/blank.png",
            "points/sub/n.jpg", "square/sub/n.jpg"} <= set(port)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _port_sources():
    for dirpath, _, names in os.walk(os.path.join(REPO, "pgx_torch")):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_port_module_imports_jax_or_pgx():
    """Static: no import statement of pgx_torch or chip_smoke.py names
    jax, pgx or __graft_entry__ (at any depth, inside functions too)."""
    banned = ("jax", "jaxlib", "pgx", "__graft_entry__", "flax", "optax")
    found = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                if m.split(".")[0] in banned:
                    found.append((os.path.relpath(path, REPO), node.lineno,
                                  m))
    assert not found, found


_PROBE = r"""
import importlib, os, pkgutil, sys
repo = sys.argv[1]
banned = ("jax", "jaxlib", "pgx", "__graft_entry__")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in banned:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
pgx_dir = os.path.join(repo, "pgx") + os.sep
opened = []

def audit(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        path = os.path.abspath(os.fsdecode(args[0]))
        if path.startswith(pgx_dir):
            opened.append(path)

sys.addaudithook(audit)
import pgx_torch
for mod in pkgutil.walk_packages(pgx_torch.__path__, "pgx_torch."):
    importlib.import_module(mod.name)
from pgx_torch.data import haar, prep
haar.load_cascade()
prep.default_face_detector()
print(sorted(m for m in sys.modules if m.split(".")[0] in banned))
print(opened)
"""


def test_the_port_imports_and_reads_nothing_of_pgx(tmp_path):
    """At run time, in a fresh interpreter where importing jax, pgx or
    __graft_entry__ raises: every pgx_torch module imports, the cascade
    loads, the detector chain resolves, and no file under pgx/ is
    opened."""
    out = subprocess.run([sys.executable, "-c", _PROBE, REPO], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-2:] == ["[]", "[]"], out.stdout
