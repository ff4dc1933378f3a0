"""Port parity: the BPE tokenizer (``tnn_tpu_torch.data.tokenizer``) and
``cli.prepare_corpus --mode bpe``.

Token ids must equal the JAX package's exactly: ``train_bpe`` learns the
same vocabulary bytes in the same merge order (``Counter.most_common``
ties included), ``encode`` gives the same ids as whichever encoder the JAX
tokenizer uses on this host (its native one when ``native/`` is built, its
Python one otherwise; the two agree by the JAX package's own tests), and a
vocab.bin written by either package loads in the other.
"""
import numpy as np
import pytest

from tnn_tpu.cli import prepare_corpus as jprep
from tnn_tpu.data import tokenizer as jtok
from tnn_tpu_torch.cli import prepare_corpus
from tnn_tpu_torch.data import tokenizer as ttok

CORPUS = [
    "The quick brown fox jumps over the lazy dog. " * 3,
    "def train(model, steps=1000):\n    for i in range(steps):\n"
    "        loss = model.step(i)  # 12.5% faster\n",
    "Ünïcödé: naïve café, 東京 and Москва; emoji 🙂🙂 done.",
    "numbers 1234567890 and 3.14159, 2026-10-17, 42 42 42",
    "tabs\tand   runs   of    spaces\n\n\nnewlines  \n",
    "it's we're they've I'm you'll he'd <|endoftext|> next document",
]

TEXTS = {
    "ascii": "Hello, world! The fox jumps over the lazy dog again.",
    "unicode": "naïve café 東京 Москва 🙂 — über straße",
    "digits": "pi is 3.14159265, e is 2.71828 and 1000000 is big",
    "whitespace": "a  b   c\t\td\n\n\ne     \n  trailing   ",
    "eot": "first doc<|endoftext|>second doc <|endoftext|><|endoftext|>end",
    "code": "for i in range(10):\n    print(i ** 2)  # squares\n",
}


@pytest.fixture(scope="module")
def vocab_paths(tmp_path_factory):
    """A vocab trained by JAX's ``train_bpe`` (up to 400 tokens: the
    corpus runs out of repeated pairs first), saved by JAX."""
    d = tmp_path_factory.mktemp("vocab")
    jv = jtok.train_bpe(CORPUS, vocab_size=400)
    path = d / "jax_vocab.bin"
    jv.save(str(path))
    return d, path


@pytest.mark.parametrize("vocab_size,min_count", [(300, 2), (400, 2),
                                                  (1000, 1)])
def test_train_bpe_learns_the_jax_vocabulary(vocab_size, min_count):
    mine = ttok.train_bpe(CORPUS, vocab_size=vocab_size,
                          min_pair_count=min_count)
    ref = jtok.train_bpe(CORPUS, vocab_size=vocab_size,
                         min_pair_count=min_count)
    assert mine._vocab == ref._vocab
    assert mine.vocab_size == ref.vocab_size
    assert mine.eot_token == ref.eot_token == mine.vocab_size - 1


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_encode_decode_match_jax(vocab_paths, name):
    _, path = vocab_paths
    mine = ttok.Tokenizer().load(str(path))
    ref = jtok.Tokenizer().load(str(path))
    text = TEXTS[name]
    ids = mine.encode(text)
    assert ids == list(ref.encode(text))
    assert mine.decode(ids) == ref.decode(ids) == text
    assert mine.encode(text, allowed_special=False) == \
        list(ref.encode(text, allowed_special=False))


def test_vocab_files_cross_both_ways(vocab_paths, tmp_path):
    _, jax_path = vocab_paths
    mine = ttok.Tokenizer().load(str(jax_path))
    port_path = tmp_path / "port_vocab.bin"
    mine.save(str(port_path))
    assert port_path.read_bytes() == jax_path.read_bytes()
    ours = ttok.train_bpe(CORPUS, vocab_size=350)
    ours.save(str(tmp_path / "trained.bin"))
    theirs = jtok.Tokenizer().load(str(tmp_path / "trained.bin"))
    assert theirs._vocab == ours._vocab
    text = TEXTS["code"] + TEXTS["eot"]
    assert list(theirs.encode(text)) == ours.encode(text)


def test_decode_token_and_unloaded_tokenizer(vocab_paths):
    _, path = vocab_paths
    mine = ttok.Tokenizer().load(str(path))
    ref = jtok.Tokenizer().load(str(path))
    for i in (0, 65, 255, 256, mine.vocab_size - 1, mine.vocab_size, -1):
        assert mine.decode_token(i) == ref.decode_token(i)
    assert mine.decode([mine.vocab_size + 5]) == "<unk>"
    with pytest.raises(RuntimeError, match="not loaded"):
        ttok.Tokenizer().encode("x")


def test_prepare_corpus_bpe_with_a_vocab_matches_jax(vocab_paths, tmp_path):
    d, path = vocab_paths
    src = tmp_path / "src"
    src.mkdir()
    for i, text in enumerate(CORPUS):
        (src / f"doc{i}.py").write_text(text)
    args = ["--source", str(src), "--mode", "bpe", "--vocab", str(path),
            "--val-fraction", "0.2"]
    jprep.main(["--out", str(tmp_path / "jax")] + args)
    meta = prepare_corpus.main(["--out", str(tmp_path / "port")] + args)
    for name in ("train.bin", "val.bin", "meta.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    n = ttok.Tokenizer().load(str(path)).vocab_size
    assert meta["vocab_size"] == n
    ids = np.fromfile(tmp_path / "port" / "train.bin", np.uint16)
    assert ids.max() < n and (ids == n - 1).any()     # <|endoftext|>
