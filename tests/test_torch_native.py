"""The port's native host runtime (``tnn_tpu_torch.native``) and its
users, against the port's numpy paths and the JAX package's native API.

The classes of ``tests/test_native.py`` run against the port: each entry
point is held against the port's own numpy (or PIL) path and, where the
JAX package's library loads, against ``tnn_tpu.native.api`` on the same
inputs (both libraries build from ``native/src``: their bytes must be
equal). The loaders give the same arrays with the library and without it,
the library lies under ``build/native/`` (never ``native/build/``), and
the affinity helpers and the CPU topology read what the JAX package's
read. Skipped where no compiler builds the library, as test_native.py
skips.
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from tnn_tpu_torch import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime not built (no g++)")

from tnn_tpu_torch.native import api  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def japi():
    """The JAX package's native API, or None where its library is not
    built."""
    from tnn_tpu import native as jnative

    return jnative.api if jnative.available() else None


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


class TestGather:
    @pytest.mark.parametrize("dtype", ["float32", "uint8"])
    def test_gather_rows_matches_numpy_and_jax(self, japi, dtype):
        rng = np.random.default_rng(0)
        src = (rng.standard_normal((200, 5, 7)).astype(np.float32)
               if dtype == "float32"
               else rng.integers(0, 256, (200, 5, 7), dtype=np.uint8))
        idx = np.array([0, 199, 17, 17, 3])
        got = api.gather_rows(src, idx)
        _same(got, src[idx])
        if japi is not None:
            _same(got, japi.gather_rows(src, idx))

    @pytest.mark.parametrize("channels,stats", [(3, True), (1, False)])
    def test_gather_normalize_matches_formula_and_jax(self, japi, channels,
                                                      stats):
        """(x / 255 - mean) / std as the library computes it: x * a + b in
        f32 with a = 1 / (255 std), b = -mean / std, fused into one
        rounding where g++ contracts it, else two."""
        rng = np.random.default_rng(2)
        src = rng.integers(0, 256, (40, 8, 8, channels), dtype=np.uint8)
        idx = np.array([1, 39, 20])
        mean = np.array([0.48, 0.45, 0.40][:channels], np.float32) \
            if stats else None
        std = np.array([0.22, 0.23, 0.24][:channels], np.float32) \
            if stats else None
        got = api.gather_normalize(src, idx, mean, std)
        s = std if stats else np.ones(channels, np.float32)
        m = mean if stats else np.zeros(channels, np.float32)
        a, b = np.float32(1.0) / (np.float32(255.0) * s), -m / s
        x = src[idx]
        fused = (x.astype(np.float64) * a.astype(np.float64)
                 + b.astype(np.float64)).astype(np.float32)
        assert got.tobytes() in (fused.tobytes(),
                                 (x.astype(np.float32) * a + b).tobytes())
        np.testing.assert_allclose(got, (x / 255.0 - m) / s, rtol=1e-5,
                                   atol=1e-6)
        if japi is not None:
            _same(got, japi.gather_normalize(src, idx, mean, std))

    def test_epoch_permutation(self, japi):
        a = api.epoch_permutation(500, 7)
        assert sorted(a.tolist()) == list(range(500))
        _same(a, api.epoch_permutation(500, 7))
        assert not np.array_equal(a, api.epoch_permutation(500, 8))
        if japi is not None:
            _same(a, japi.epoch_permutation(500, 7))


def _mnist_csv(path, n=12, seed=4):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 784))
    labels = rng.integers(0, 10, n)
    with open(path, "w") as f:
        f.write("label," + ",".join(f"px{i}" for i in range(784)) + "\n")
        for lab, row in zip(labels, imgs):
            f.write(f"{lab}," + ",".join(map(str, row)) + "\n")
    return imgs, labels


class TestParsers:
    def test_mnist_csv_matches_numpy_path_and_jax(self, tmp_path, japi,
                                                  monkeypatch):
        from tnn_tpu_torch.data.datasets import load_mnist_csv

        p = tmp_path / "m.csv"
        imgs, labels = _mnist_csv(p)
        gi, gl = api.mnist_csv(str(p), header=True)
        _same(gi, imgs.astype(np.uint8))
        _same(gl, labels.astype(np.int32))
        if japi is not None:
            for a, b in zip((gi, gl), japi.mnist_csv(str(p), header=True)):
                _same(a, b)
        fast = load_mnist_csv(str(p))
        monkeypatch.setattr(native, "available", lambda: False)
        for a, b in zip(fast, load_mnist_csv(str(p))):
            _same(a, b)

    def test_mnist_csv_malformed_raises(self, tmp_path):
        p = tmp_path / "bad.csv"
        p.write_text("1,2,3\n")
        with pytest.raises(ValueError, match="malformed"):
            api.mnist_csv(str(p), header=False)

    def test_mnist_float_pixels_take_numpy(self, tmp_path):
        """The native scanner declines float pixels; the loader reads them
        with numpy."""
        from tnn_tpu_torch.data.datasets import load_mnist_csv

        p = tmp_path / "f.csv"
        p.write_text(("3," + ",".join(["127.5"] * 784) + "\n") * 2)
        data, labels = load_mnist_csv(str(p))
        assert labels.tolist() == [3, 3]
        np.testing.assert_allclose(data, 0.5, rtol=1e-6)

    @pytest.mark.parametrize("kind", ["cifar10", "cifar100"])
    def test_cifar_matches_numpy_path_and_jax(self, tmp_path, japi, kind,
                                              monkeypatch):
        from tnn_tpu_torch.data import datasets

        rng = np.random.default_rng(5)
        head = 1 if kind == "cifar10" else 2
        recs = rng.integers(0, 256, (6, head + 3072), dtype=np.uint8)
        p = tmp_path / ("data_batch_1.bin" if head == 1 else "train.bin")
        recs.tofile(p)
        got = getattr(api, kind)(str(p))
        _same(got[0], recs[:, head:].reshape(6, 3, 32, 32)
              .transpose(0, 2, 3, 1).copy())
        for h in range(head):
            _same(got[1 + h], recs[:, h].astype(np.int32))
        if japi is not None:
            for a, b in zip(got, getattr(japi, kind)(str(p))):
                _same(a, b)
        load = (lambda: datasets.load_cifar10_bin([str(p)])) \
            if head == 1 else (lambda: datasets.load_cifar100_bin(str(p)))
        fast = load()
        monkeypatch.setattr(native, "available", lambda: False)
        for a, b in zip(fast, load()):
            _same(a, b)


class TestTokenFile:
    def test_windows_match_memmap_and_jax(self, tmp_path, japi):
        toks = np.random.default_rng(7).integers(0, 50257, 5000) \
            .astype(np.uint16)
        p = tmp_path / "t.bin"
        toks.tofile(p)
        tf = api.TokenFile(str(p))
        assert len(tf) == 5000
        offs = np.array([0, 1, 4000])
        got = tf.windows(offs, 129)
        for i, o in enumerate(offs):
            _same(got[i], toks[o:o + 129].astype(np.int32))
        if japi is not None:
            jtf = japi.TokenFile(str(p))
            _same(got, jtf.windows(offs, 129))
            jtf.close()
        tf.close()

    @pytest.mark.parametrize("pad", [None, 7])
    def test_loader_native_equals_numpy_path_and_jax(self, tmp_path, pad,
                                                     monkeypatch):
        from tnn_tpu.data.token_stream import \
            TokenStreamDataLoader as JaxTokens

        from tnn_tpu_torch.data.token_stream import TokenStreamDataLoader

        toks = np.random.default_rng(8).integers(0, 20, 300) \
            .astype(np.uint16)
        p = tmp_path / "t.bin"
        toks.tofile(p)
        idx = np.array([0, 5, 283])
        fast = TokenStreamDataLoader(str(p), 16, pad_token_id=pad)
        assert fast._native_tokens is not None
        got = fast._get(idx)
        ref = JaxTokens(str(p), 16, pad_token_id=pad)._get(idx)
        monkeypatch.setattr(native, "available", lambda: False)
        slow = TokenStreamDataLoader(str(p), 16, pad_token_id=pad)
        assert slow._native_tokens is None
        for a, b, c in zip(got, slow._get(idx), ref):
            _same(np.ascontiguousarray(a), b)
            _same(np.ascontiguousarray(a), np.ascontiguousarray(c))
        if pad is not None:     # masking the labels left the data alone
            assert (got[0] == pad).any() and not (got[1] == pad).any()


def _train_tiny_bpe(corpus, num_merges):
    """A merge-order vocab: the 256 bytes, merged tokens in merge order,
    then <|endoftext|> (tests/test_native.py's trainer)."""
    vocab = [bytes([i]) for i in range(256)]
    words = [[bytes([b]) for b in w.encode()] for w in corpus.split()]
    for _ in range(num_merges):
        counts = {}
        for w in words:
            for a, b in zip(w, w[1:]):
                counts[(a, b)] = counts.get((a, b), 0) + 1
        if not counts:
            break
        a, b = max(counts, key=lambda k: (counts[k], k))
        vocab.append(a + b)
        for w in words:
            i = 0
            while i < len(w) - 1:
                if w[i] == a and w[i + 1] == b:
                    w[i:i + 2] = [a + b]
                else:
                    i += 1
    vocab.append(b"<|endoftext|>")
    return vocab


class TestBpeTokenizer:
    SAMPLES = [
        "the quick brown fox", "hello world!",
        "don't it's we'll I'm you've they'd", "  spaces   everywhere  ",
        "numbers 123 999 007", "tabs\tand\nnewlines\r\n",
        "unicode: café 北京 здравствуйте", "emoji 🚀 mixed with text",
        "a<|endoftext|>b", " <|endoftext|> x", "trail  <|endoftext|>", "",
        " ", "'", "unknown zzzqqq xyzzy", "MixedCase UPPER lower_snake",
    ]

    @pytest.fixture(scope="class")
    def tokenizers(self, tmp_path_factory):
        """The port's tokenizer on the library, the same on its Python
        merge loop, and the JAX package's, over one vocab.bin."""
        from tnn_tpu.data.tokenizer import Tokenizer as JaxTokenizer

        from tnn_tpu_torch.data.tokenizer import Tokenizer

        corpus = ("the quick brown fox jumps over the lazy dog "
                  "hello world this is a test of byte pair encoding "
                  "numbers 123 456 and punctuation !!! ... don't it's") * 3
        writer = Tokenizer()
        writer._vocab = _train_tiny_bpe(corpus, 120)
        writer._build_encoder()
        vp = str(tmp_path_factory.mktemp("bpe") / "vocab.bin")
        writer.save(vp)
        fast = Tokenizer().load(vp)
        plain = Tokenizer().load(vp)
        plain._native = None
        return fast, plain, JaxTokenizer().load(vp), api.BpeTokenizer(vp)

    def test_metadata(self, tokenizers):
        fast, plain, jax_tok, nat = tokenizers
        assert fast._native is not None
        assert nat.vocab_size == plain.vocab_size == jax_tok.vocab_size
        assert nat.eot_token == plain.eot_token == jax_tok.eot_token

    def test_encode_matches_python_and_jax(self, tokenizers):
        fast, plain, jax_tok, _ = tokenizers
        for s in self.SAMPLES:
            assert fast.encode(s) == plain.encode(s) == jax_tok.encode(s), \
                repr(s)

    def test_decode_matches_and_roundtrips(self, tokenizers):
        _, plain, _, nat = tokenizers
        for s in self.SAMPLES:
            ids = plain.encode(s)
            assert nat.decode(ids) == plain.decode(ids)
        txt = "round trip of don't  stop 123!"
        assert nat.decode(nat.encode(txt)) == txt

    def test_long_text(self, tokenizers):
        fast, plain, _, _ = tokenizers
        rng = np.random.default_rng(0)
        chars = np.array(list("abcdefghijklmnopqrstuvwxyzAB0123456789 .,!?'"))
        text = " ".join("".join(rng.choice(chars, int(rng.integers(1, 13))))
                        for _ in range(500))
        assert fast.encode(text) == plain.encode(text)

    def test_out_of_range_decode(self, tokenizers):
        assert tokenizers[3].decode_bytes(np.array([10 ** 6], np.int32)) \
            == b"<unk>"

    def test_allowed_special_false_takes_python(self, tokenizers):
        fast, plain, _, _ = tokenizers
        s = "a<|endoftext|>b"
        assert fast.encode(s, allowed_special=False) == \
            plain.encode(s, allowed_special=False) != fast.encode(s)


class TestLoaderIntegration:
    @pytest.mark.parametrize("dtype", ["float32", "uint8"])
    def test_array_loader_native_gather_equals_numpy(self, dtype,
                                                     monkeypatch):
        from tnn_tpu_torch.data.loader import ArrayDataLoader

        rng = np.random.default_rng(9)
        data = rng.integers(0, 256, (128, 6, 6, 3)).astype(dtype)
        labels = rng.integers(0, 10, 128).astype(np.int32)
        fast = ArrayDataLoader(data, labels)
        assert fast._native_gather
        idx = rng.integers(0, 128, 32)
        got = fast._get(idx)
        monkeypatch.setattr(native, "available", lambda: False)
        slow = ArrayDataLoader(data, labels)
        assert not slow._native_gather
        for a, b in zip(got, slow._get(idx)):
            _same(a, b)

    def test_non_contiguous_and_other_dtypes_keep_numpy(self):
        from tnn_tpu_torch.data.loader import ArrayDataLoader

        data = np.zeros((8, 4, 4), np.float32)
        assert not ArrayDataLoader(data[:, ::2], np.zeros(8)). _native_gather
        assert not ArrayDataLoader(data.astype(np.float64),
                                   np.zeros(8))._native_gather
        assert not ArrayDataLoader(np.zeros(8, np.float32),
                                   np.zeros(8))._native_gather

    def test_tnn_native_0_turns_the_runtime_off(self):
        code = ("from tnn_tpu_torch import native; "
                "from tnn_tpu_torch.distributed import make_transport; "
                "t = make_transport(listen_port=None); "
                "print(native.available(), type(t).__name__)")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env={**os.environ, "TNN_NATIVE": "0"},
                              capture_output=True, text=True, timeout=120)
        assert proc.stdout.split() == ["False", "PyTransport"], proc.stderr


class TestLibrary:
    def test_built_under_build_native_with_the_makefiles_flags(self):
        lib = native.get_lib()
        assert pathlib.Path(lib._name).resolve() == \
            (ROOT / "build" / "native" / "libtnn_host.so").resolve()
        assert native.lib.SRC_DIR == ROOT / "native" / "src"
        make = (ROOT / "native" / "Makefile").read_text()
        for var, flags in (("CXXFLAGS", native.lib.CXXFLAGS),
                           ("LDFLAGS", native.lib.LDFLAGS)):
            line = re.search(rf"^{var} \?= (.*)$", make, re.M).group(1)
            assert line.split() == flags

    def test_rebuild_writes_only_its_own_directory(self, tmp_path,
                                                   monkeypatch):
        """A forced build lands in the build directory it is given and
        leaves ``native/`` (sources and the JAX package's build) as it
        was."""
        def listing():
            return sorted((str(p.relative_to(ROOT / "native")),
                           p.stat().st_mtime_ns)
                          for p in (ROOT / "native").rglob("*")
                          if p.is_file())

        before = listing()
        monkeypatch.setattr(native.lib, "BUILD_DIR", tmp_path / "native")
        out = native.build_native(force=True)
        assert pathlib.Path(out) == tmp_path / "native" / "libtnn_host.so"
        assert sorted(p.name for p in (tmp_path / "native").iterdir()) == \
            [".lock", "libtnn_host.so"]
        assert listing() == before


# -- images -------------------------------------------------------------------

Image = pytest.importorskip("PIL.Image")


def _grad_image(h, w, rng):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 / w, y * 255 / h,
                    (x + y) * 127 / (w + h) + rng.standard_normal((h, w)) * 8],
                   -1)
    return np.clip(img, 0, 255).astype(np.uint8)


class TestNativePngDecode:
    def test_all_color_types_exact(self, tmp_path, japi):
        rng = np.random.default_rng(0)
        paths, refs = [], []
        for i, mode in enumerate(["RGB", "L", "RGBA", "P", "LA"]):
            im = Image.fromarray(rng.integers(0, 255, (20, 24, 3),
                                              np.uint8)).convert(mode)
            paths.append(str(tmp_path / f"{i}_{mode}.png"))
            im.save(paths[-1])
            refs.append(np.asarray(im.convert("RGB"), np.uint8))
        out, ok = api.decode_image_batch(paths, 20, 24)
        assert ok.all()
        for got, ref in zip(out, refs):
            _same(got, ref)
        if japi is not None:
            _same(out, japi.decode_image_batch(paths, 20, 24)[0])

    def test_resize_matches_numpy_bilinear_and_jax(self, tmp_path, japi):
        from tnn_tpu_torch.data.datasets import _resize_bilinear

        arr = np.random.default_rng(1).integers(0, 255, (33, 17, 3),
                                                np.uint8)
        p = str(tmp_path / "x.png")
        Image.fromarray(arr).save(p)
        out, ok = api.decode_image_batch([p, p], 16, 16)
        assert ok.all()
        ref = _resize_bilinear(arr[None], (16, 16))[0]
        assert np.abs(out[0].astype(int) - ref.astype(int)).max() <= 1
        if japi is not None:
            _same(out, japi.decode_image_batch([p, p], 16, 16)[0])

    def test_resize_bilinear_batch_matches_numpy_and_jax(self, japi):
        from tnn_tpu_torch.data.datasets import _resize_bilinear

        frames = np.random.default_rng(3).integers(0, 255, (7, 41, 29, 3),
                                                   np.uint8)
        out = api.resize_bilinear_batch(frames, 24, 16)
        assert out.shape == (7, 24, 16, 3)
        assert np.abs(out.astype(int) -
                      _resize_bilinear(frames, (24, 16)).astype(int)
                      ).max() <= 1
        _same(api.resize_bilinear_batch(frames, 41, 29), frames)
        if japi is not None:
            _same(out, japi.resize_bilinear_batch(frames, 24, 16))

    def test_bad_file_falls_back_flag(self, tmp_path):
        good = str(tmp_path / "good.png")
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(good)
        bad = str(tmp_path / "bad.png")
        pathlib.Path(bad).write_bytes(b"definitely not a png")
        out, ok = api.decode_png_batch([good, bad], 8, 8)
        assert ok[0] and not ok[1] and out[1].sum() == 0


class TestNativeJpegDecode:
    @pytest.mark.parametrize("progressive", [False, True])
    @pytest.mark.parametrize("w,h,sub,mode,q", [
        (64, 64, 0, "RGB", 95), (128, 128, 1, "RGB", 85),
        (97, 53, 2, "RGB", 90), (64, 64, 2, "L", 90)])
    def test_matches_pil_and_jax(self, tmp_path, japi, w, h, sub, mode, q,
                                 progressive):
        """Within mean 1 / max 8 counts of PIL (conforming decoders differ
        in IDCT and chroma upsampling, tests/test_native.py), and equal to
        the JAX package's library byte for byte."""
        img = _grad_image(h, w, np.random.default_rng(0))
        p = str(tmp_path / "t.jpg")
        Image.fromarray(img if mode == "RGB" else img[:, :, 0], mode).save(
            p, "JPEG", quality=q, subsampling=sub, progressive=progressive)
        ref = np.asarray(Image.open(p).convert("RGB"), np.uint8)
        out, ok = api.decode_image_batch([p], h, w)
        assert ok[0]
        d = np.abs(out[0].astype(int) - ref.astype(int))
        assert d.mean() < 1.0 and d.max() <= 8, (d.mean(), d.max())
        if japi is not None:
            _same(out, japi.decode_image_batch([p], h, w)[0])

    def test_truncated_falls_back(self, tmp_path):
        p = str(tmp_path / "t.jpg")
        Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(p, "JPEG")
        bad = str(tmp_path / "trunc.jpg")
        pathlib.Path(bad).write_bytes(pathlib.Path(p).read_bytes()[:40])
        out, ok = api.decode_image_batch([p, bad], 32, 32)
        assert ok[0] and not ok[1] and out[1].sum() == 0


@pytest.mark.parametrize("ext", ["png", "JPEG"])
def test_image_folder_loader_native_against_its_pil_path(tmp_path, ext,
                                                         monkeypatch):
    """The image folder decodes natively (the same frames as the library's
    batch call), labels and order equal to its PIL path's; PNGs at their
    own size decode to PIL's pixels exactly."""
    from tnn_tpu_torch.data.datasets import ImageFolderDataLoader

    rng = np.random.default_rng(2)
    for c in range(2):
        d = tmp_path / f"class{c}"
        d.mkdir()
        for i in range(3):
            Image.fromarray(_grad_image(24, 24, rng)).save(
                str(d / f"{i}.{ext}"), **({"quality": 92}
                                          if ext == "JPEG" else {}))
    fast = ImageFolderDataLoader(str(tmp_path), image_size=(24, 24))
    assert fast._native_img
    idx = np.arange(6)
    a, la = fast._get(idx)
    frames, ok = api.decode_image_batch([fast._items[i][1] for i in idx],
                                        24, 24)
    assert ok.all()
    _same(a, frames.astype(np.float32) / 255.0)
    monkeypatch.setattr(native, "available", lambda: False)
    slow = ImageFolderDataLoader(str(tmp_path), image_size=(24, 24))
    assert not slow._native_img
    b, lb = slow._get(idx)
    _same(la, lb)
    diff = np.abs(a - b) * 255
    if ext == "png":
        assert diff.max() < 1e-3
    else:
        assert diff.mean() < 1.0 and diff.max() <= 8.001


def test_image_folder_npy_resize_native_within_one_count(tmp_path,
                                                         monkeypatch):
    from tnn_tpu_torch.data.datasets import ImageFolderDataLoader

    rng = np.random.default_rng(4)
    for c in range(2):
        (tmp_path / f"c{c}").mkdir()
        np.save(tmp_path / f"c{c}" / "images.npy",
                rng.integers(0, 256, (5, 20, 30, 3), dtype=np.uint8))
    idx = np.arange(10)
    a, _ = ImageFolderDataLoader(str(tmp_path), image_size=(16, 16))._get(idx)
    monkeypatch.setattr(native, "available", lambda: False)
    b, _ = ImageFolderDataLoader(str(tmp_path), image_size=(16, 16))._get(idx)
    assert (np.abs(a - b) * 255).max() <= 1.001


# -- affinity and the CPU topology -------------------------------------------

def test_affinity_helpers_match_jax(monkeypatch):
    from tnn_tpu.utils import affinity as jaff

    from tnn_tpu_torch.utils import affinity

    for spec in ("0-3,8,10-11", "5", " 2 , 1-2 ,", ""):
        assert affinity.parse_cpu_list(spec) == jaff.parse_cpu_list(spec)
    assert affinity.available_cpus() == jaff.available_cpus()
    assert affinity.core_types() == jaff.core_types()
    for reserve in (None, 0, 1, 3, 1000):
        assert affinity.io_cpu_set(reserve) == jaff.io_cpu_set(reserve)
    monkeypatch.setenv("TNN_IO_CPUS", "1-2")
    assert affinity.io_cpu_set() == jaff.io_cpu_set() == [1, 2]
    monkeypatch.delenv("TNN_PIN_IO", raising=False)
    assert affinity.pin_io_thread() is False


def test_cpu_topology_matches_jax_and_cli_prints_it(capsys):
    from tnn_tpu.utils.hardware import cpu_topology as jax_topology

    from tnn_tpu_torch.cli import hardware_info
    from tnn_tpu_torch.utils.hardware import cpu_topology

    assert cpu_topology() == jax_topology()
    info = hardware_info.main([])
    out = capsys.readouterr().out
    assert f"IO cpu set: {info['io_cpu_set']}" in out
    assert "P-cores:" in out and info["cpu"] == cpu_topology()
