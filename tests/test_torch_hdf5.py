"""The port's own HDF5 reader (`deeplearning4j_tpu_torch.modelimport.hdf5`)
against h5py.

- The eight Keras fixtures (`tests/fixtures/real_*.h5`): every group
  path in the same order, every attribute (decoded strings and numeric
  values, the same Python and numpy types as h5py's), and every dataset
  (dtype, shape, bit-equal bytes).
- Files h5py writes here that cover the subset's corners: scalar and
  array attributes of variable- and fixed-length strings, numeric
  attributes, f2 / f4 / f8 / i4 / i8 / u1 datasets, an empty dataset, a
  scalar one, a compact one, unwritten ones (read as their fill value), a
  group of 200 members (a two-level B-tree), and an object header whose
  attributes need continuation blocks.
- Outside the subset the reader raises NotImplementedError naming the
  feature: a libver="latest" file (superblock 3), a chunked gzip dataset,
  a chunked one, a big-endian one, a compound one, a float whose layout
  is not IEEE 754.
- Files with a user block before the superblock and with 2-, 4- and
  8-byte offsets and lengths.
- A subprocess in which h5py (and tf_keras) cannot be imported imports a
  fixture through the port's entry point.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from torch_threads import one_torch_thread  # noqa: E402,F401

from deeplearning4j_tpu_torch.modelimport.hdf5 import (  # noqa: E402
    Dataset, Group, Hdf5Archive)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures")
FIXTURES = ("real_mlp", "real_cnn", "real_cnn_chfirst", "real_lstm",
            "real_functional", "real_keras1_th", "real_resnet_residual",
            "real_vgg16_trained")


def _same_value(got, want, where):
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        assert got.shape == want.shape, (where, got.shape, want.shape)
        if want.dtype == object:
            assert all(type(a) is type(b) and a == b
                       for a, b in zip(got.ravel(), want.ravel())), where
        else:
            assert got.tobytes() == want.tobytes(), where
    elif isinstance(want, np.generic):
        assert got.dtype == want.dtype and got.tobytes() == \
            want.tobytes(), where
    else:
        assert got == want, where


def _same_attrs(got, want, where):
    assert sorted(got.keys()) == sorted(want.keys()), where
    for k in want.keys():
        _same_value(got[k], want[k], f"{where}@{k}")


def _same_tree(group, hgroup, where="/"):
    """Walk both trees; returns (groups, datasets, attributes) seen."""
    assert list(group.keys()) == list(hgroup.keys()), where
    _same_attrs(group.attrs, hgroup.attrs, where)
    counts = np.array([1, 0, len(hgroup.attrs)])
    for k in hgroup.keys():
        obj, hobj = group[k], hgroup[k]
        path = f"{where.rstrip('/')}/{k}"
        if isinstance(hobj, h5py.Group):
            assert isinstance(obj, Group), path
            counts += _same_tree(obj, hobj, path)
            continue
        assert isinstance(obj, Dataset), path
        got, want = obj.read(), np.asarray(hobj[()])
        assert obj.shape == hobj.shape and obj.dtype == hobj.dtype, path
        _same_value(got, want, path)
        _same_attrs(obj.attrs, hobj.attrs, path)
        counts += [0, 1, len(hobj.attrs)]
    return counts


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_equals_h5py(name):
    path = os.path.join(FIXDIR, f"{name}.h5")
    with Hdf5Archive(path) as archive, h5py.File(path, "r") as f:
        groups, datasets, attrs = _same_tree(archive.root, f)
        assert datasets > 0 and attrs > 0
        # the archive's API over the same file
        assert archive.has_group("model_weights")
        assert archive.groups("model_weights") == [
            k for k, v in f["model_weights"].items()
            if isinstance(v, h5py.Group)]
        assert archive.read_attribute_as_json("model_config")["class_name"]
        for lname in archive.groups("model_weights"):
            lw = archive.layer_weights(archive.root["model_weights"][lname])
            for wname, arr in lw.items():
                want = np.asarray(f["model_weights"][lname][wname])
                assert arr.tobytes() == want.tobytes(), (lname, wname)


@pytest.fixture(scope="module")
def corners(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hdf5") / "corners.h5")
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f.attrs["s_vlen"] = "hello"
        f.attrs["s_vlen_utf8"] = "héllo ☃"
        f.attrs["s_vlen_empty"] = ""
        f.attrs["s_fixed"] = np.bytes_(b"fixed")
        f.attrs["a_vlen"] = ["a", "bb", "", "dddd"]
        f.attrs["a_fixed"] = np.array([b"x", b"yy", b"zzz"], dtype="S3")
        f.attrs["i"] = 7
        f.attrs["f"] = 2.5
        f.attrs["arr"] = np.arange(6, dtype="<i4").reshape(2, 3)
        f.attrs["empty"] = np.array([])
        for dt in ("f2", "f4", "f8", "i4", "i8", "u1"):
            data = rng.normal(size=(3, 5)) * 50
            ds = f.create_dataset("d_" + dt, data=data.astype(dt))
            ds.attrs["unit"] = dt
        f.create_dataset("empty", data=np.zeros((0, 4), "f4"))
        f.create_dataset("scalar", data=np.float32(3.0))
        f.create_dataset("unwritten", shape=(4,), dtype="f4")
        f.create_dataset("unwritten_fill", shape=(2, 3), dtype="i4",
                         fillvalue=9)
        f.create_dataset("fixed_str", data=np.array([b"ab", b"cde"],
                                                    dtype="S4"))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_DOUBLE,
                        h5py.h5s.create_simple((5,)), dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(5, dtype="f8"))
        big = f.create_group("big")
        for i in range(200):
            big.create_dataset(f"m{i:03d}", data=np.array([i], "i8"))
        many = f.create_group("many").create_group("nested")
        for i in range(60):
            many.attrs[f"attr{i:02d}"] = np.arange(i + 1, dtype="f8")
        many.attrs["late"] = "x" * 300
    return path


def test_corner_file_equals_h5py(corners):
    with Hdf5Archive(corners) as archive, h5py.File(corners, "r") as f:
        groups, datasets, attrs = _same_tree(archive.root, f)
    assert (groups, datasets) == (4, 212)
    assert attrs == 10 + 6 + 61


@pytest.mark.parametrize("name,dtype,shape", [
    ("d_f2", "float16", (3, 5)), ("d_f4", "float32", (3, 5)),
    ("d_f8", "float64", (3, 5)), ("d_i4", "int32", (3, 5)),
    ("d_i8", "int64", (3, 5)), ("d_u1", "uint8", (3, 5)),
    ("empty", "float32", (0, 4)), ("scalar", "float32", ()),
    ("unwritten", "float32", (4,)), ("unwritten_fill", "int32", (2, 3)),
    ("fixed_str", "|S4", (2,)), ("compact", "float64", (5,))])
def test_corner_dataset(corners, name, dtype, shape):
    with Hdf5Archive(corners) as archive, h5py.File(corners, "r") as f:
        got = archive.read_dataset(name)
        want = np.asarray(f[name][()])
    assert got.dtype == np.dtype(dtype) and got.shape == shape
    assert got.tobytes() == want.tobytes()
    if name == "unwritten_fill":
        assert (got == 9).all()


@pytest.mark.parametrize("userblock,sizes", [
    (512, (8, 8)), (0, (4, 4)), (1024, (4, 8)), (0, (8, 4)),
    (512, (2, 2))])
def test_userblock_and_field_sizes(tmp_path, userblock, sizes):
    """Addresses relative to a base after a user block, and the sizes of
    offsets and lengths that the superblock sets (every address, heap
    offset, length, dimension and vlen heap id is read at that width)."""
    path = str(tmp_path / "sizes.h5")
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    if userblock:
        fcpl.set_userblock(userblock)
    fcpl.set_sizes(*sizes)
    with h5py.File(h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC,
                                   fcpl=fcpl)) as f:
        f.attrs["ñame"] = "utf8 name"
        f.attrs["s"] = ["a", "bcd", "x" * 100]
        f.attrs["fixed"] = np.array([b"ab", b"c"], dtype="S2")
        g = f.create_group("g")
        for i in range(40):
            g.create_dataset(f"d{i:02d}", data=np.arange(i + 1, dtype="f4"))
        g.attrs["n"] = np.int32(40)
    with Hdf5Archive(path) as archive, h5py.File(path, "r") as f:
        assert (archive._f.so, archive._f.sl) == sizes
        assert archive._f.base == userblock
        groups, datasets, attrs = _same_tree(archive.root, f)
    assert (groups, datasets, attrs) == (2, 40, 4)


def test_corner_structures(corners):
    """The 200-member group sits under a B-tree with an internal level;
    the 61-attribute header spans continuation blocks."""
    with Hdf5Archive(corners) as archive:
        f = archive._f
        big = archive.root["big"]
        btree = f.header(big.address).symbol_table[0]
        assert f._mm[btree + 5] >= 1            # node level
        assert big.keys() == [f"m{i:03d}" for i in range(200)]
        assert archive.read_dataset("big", "m123")[0] == 123
        nested = archive.root["many/nested"]
        assert f.header(nested.address).continuations >= 1
        assert nested.attrs["attr59"][-1] == 59.0
        assert archive.datasets("big")[:2] == ["m000", "m001"]
        assert archive.groups() == ["big", "many"]
        assert archive.read_attribute_as_string_list("a_fixed") == [
            "x", "yy", "zzz"]
        assert archive.read_attribute_as_string("s_vlen_utf8") == \
            "héllo ☃"
        assert archive.read_attribute_as_json("nope") is None


def _refused(tmp_path, name, write, match, read=None):
    path = str(tmp_path / f"{name}.h5")
    write(path)
    with pytest.raises(NotImplementedError, match=match):
        archive = Hdf5Archive(path)
        try:
            (read or (lambda a: a.read_dataset("x")))(archive)
        finally:
            archive.close()


def test_latest_format_refused(tmp_path):
    def write(p):
        with h5py.File(p, "w", libver="latest") as f:
            f.create_dataset("x", data=[1.0])
            f.attrs["model_config"] = "{}"
    _refused(tmp_path, "latest", write, "superblock version")


@pytest.mark.parametrize("kind", ["gzip", "chunked", "big_endian",
                                  "compound", "non_ieee_float"])
def test_dataset_outside_subset_refused(tmp_path, kind):
    def write(p):
        with h5py.File(p, "w") as f:
            if kind == "gzip":
                f.create_dataset("x", data=np.arange(100.0), chunks=(10,),
                                 compression="gzip")
            elif kind == "chunked":
                f.create_dataset("x", data=np.arange(100.0), chunks=(10,))
            elif kind == "big_endian":
                f.create_dataset("x", data=np.arange(4, dtype=">f4"))
            elif kind == "non_ieee_float":
                t = h5py.h5t.IEEE_F32LE.copy()
                t.set_ebias(100)
                h5py.h5d.create(f.id, b"x", t, h5py.h5s.create_simple((3,)))
            else:
                f.create_dataset("x", data=np.zeros(2, dtype=[("a", "f4"),
                                                              ("b", "i4")]))
    match = {"gzip": "filter", "chunked": "chunked",
             "big_endian": "big-endian", "compound": "compound",
             "non_ieee_float": "IEEE"}[kind]
    _refused(tmp_path, kind, write, match)


def test_imports_without_h5py():
    """h5py and tf_keras blocked in a fresh interpreter: the port's
    entry point imports a fixture and reproduces its golden output."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['tf_keras'] = None\n"
        "import numpy as np\n"
        "from deeplearning4j_tpu_torch.modelimport import "
        "import_keras_model_auto\n"
        f"fix = {FIXDIR!r}\n"
        "net = import_keras_model_auto(fix + '/real_cnn.h5', device='cpu')\n"
        "g = np.load(fix + '/real_cnn_golden.npz')\n"
        "got = net.output(g['x']).numpy()\n"
        "np.testing.assert_allclose(got, g['y'], rtol=1e-4, atol=1e-5)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('h5py', 'tf_keras', 'jax', 'deeplearning4j_tpu') and "
        "sys.modules[m] is not None)\n"
        "print('ok', bad)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok []"
