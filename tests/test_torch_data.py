"""Port parity: the prompted jsonl dataset and the threaded batch loader vs
the JAX package, on a seeded synthetic corpus (jsonl rows + 16 kHz WAV).

Each package builds its dataset with its own tokenizer; the labels (all
four prompt strategies, and the 5% random-description perturbation at the
same seed), the bias spans, the log-mel features (atol 1e-5), raw audio and
speed perturbation must agree, and ``BatchLoader`` must give the same batch
order, also after ``resume``."""

import json
import wave

import numpy as np
import pytest

from whisper_context_biasing_tpu.data.dataset import PromptWhisperDataset as JaxDataset
from whisper_context_biasing_tpu.data.prefetch import BatchLoader as JaxBatchLoader
from whisper_context_biasing_tpu.tokenizer import load_tokenizer as jax_load_tokenizer
from whisper_context_biasing_tpu_torch.data import (
    BatchLoader,
    PromptWhisperDataset,
    prefetch_to_device,
    read_jsonl,
)
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

TEXTS = ["Take aspirin daily.", "Promisec treats pressure!", "Metformin, twice a day?",
         "No drugs mentioned here.", "Lisinopril and atorvastatin at night.",
         "Acid reflux; take omeprazole.", "Insulin before meals.", "Warfarin dose checked."]
BIAS = [["aspirin"], ["Promisec"], ["metformin"], [], ["lisinopril", "atorvastatin"],
        ["omeprazole"], ["insulin"], ["warfarin"]]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    (root / "jsonl").mkdir()
    for phase in ("train", "dev"):
        (root / "audio" / phase).mkdir(parents=True)
        with open(root / "jsonl" / f"{phase}.jsonl", "w") as f:
            for i, (text, bias) in enumerate(zip(TEXTS, BIAS)):
                desc = "" if i == 6 else f"Patient note {i}: {text.lower()}"
                f.write(json.dumps({"id": str(i), "file": f"a{i}.wav", "text": text,
                                    "description": desc, "bias_words": bias}) + "\n")
            f.write("\n")
        for i in range(len(TEXTS)):
            sig = (rng.standard_normal(int(16000 * (0.5 + 0.25 * i))) * 3000).astype(np.int16)
            with wave.open(str(root / "audio" / phase / f"a{i}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(sig.tobytes())
    return root


def _pair(corpus, phase="train", **kw):
    args = (str(corpus / "audio"), str(corpus / "jsonl"), phase)
    return (PromptWhisperDataset(*args, tokenizer=load_tokenizer(), **kw),
            JaxDataset(*args, tokenizer=jax_load_tokenizer(), **kw))


STRATEGIES = {
    "plain": dict(),
    "desc_only": dict(prompt=True),
    "bias_list_only": dict(bias_list=True, bias_nums=3),
    "desc_then_bias": dict(prompt=True, bias_list=True, bias_nums=3),
    "bias_then_desc": dict(prompt=True, bias_list=True, bias_nums=3, bias_desc=True),
    "desc_random": dict(prompt=True, random=True, seed=5),
    "both_random": dict(prompt=True, bias_list=True, bias_nums=4, random=True, seed=7),
}


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_labels_and_spans_match_jax(corpus, strategy):
    ds, jds = _pair(corpus, **STRATEGIES[strategy])
    assert len(ds) == len(jds) == len(TEXTS)
    assert ds.data == jds.data  # the load-time random prompt draws
    # every epoch re-draws the per-item perturbation and bias fill
    for epoch in range(25 if "random" in strategy else 2):
        ds.epoch_hint = jds.epoch_hint = epoch
        for i in range(len(ds)):
            assert ds.build_label_sequence(i) == jds.build_label_sequence(i), (epoch, i)
    assert ds.all_bias_spans() == jds.all_bias_spans()


def test_items_match_jax(corpus):
    ds, jds = _pair(corpus, prompt=True, bias_list=True, bias_nums=3)
    for i in (0, 4, 7):
        got, want = ds[i], jds[i]
        assert sorted(got) == sorted(want) == ["bias_spans", "input_features", "labels"]
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert got["bias_spans"] == want["bias_spans"]
        assert got["input_features"].shape == (80, 3000)
        np.testing.assert_allclose(got["input_features"], want["input_features"], atol=1e-5,
                                   rtol=0)


def test_raw_audio_and_speed_perturb_match_jax(corpus):
    kw = dict(return_audio=True, speed_perturb=(0.9, 1.0, 1.1), seed=3)
    ds, jds = _pair(corpus, **kw)
    for epoch in range(3):
        ds.epoch_hint = jds.epoch_hint = epoch
        for i in range(len(ds)):
            got, want = ds[i]["audio"], jds[i]["audio"]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    dev, jdev = _pair(corpus, phase="dev", **kw)  # no perturbation outside train
    np.testing.assert_array_equal(dev[5]["audio"], jdev[5]["audio"])


def test_read_jsonl_skips_blank_and_malformed(tmp_path):
    path = tmp_path / "x.jsonl"
    path.write_text('{"a": 1}\n\nnot json\n{"b": 2}\n')
    assert read_jsonl(str(path)) == [{"a": 1}, {"b": 2}]
    with pytest.raises(FileNotFoundError):
        read_jsonl(str(tmp_path / "missing.jsonl"))


class _Rows:
    """A dataset of row indices (keeps the loader test free of audio)."""

    def __init__(self, n):
        self.n, self.epoch_hint = n, 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_loader_order_matches_jax(drop_last):
    def run(cls, resume=None):
        loader = cls(_Rows(23), list, 4, shuffle=True, seed=11, drop_last=drop_last,
                     num_workers=3)
        if resume:
            loader.resume(*resume)
        epochs = [list(loader) for _ in range(3)]
        return epochs, len(loader)

    for resume in (None, (2, 3)):
        assert run(BatchLoader, resume) == run(JaxBatchLoader, resume)
    (first, *_), n = run(BatchLoader, (1, 2))
    assert len(first) == n - 2


def test_prefetch_to_device_on_cpu_passes_batches_through():
    batches = [{"x": np.arange(3) + i} for i in range(3)]
    out = list(prefetch_to_device(iter(batches), device="cpu"))
    assert all(a is b for a, b in zip(out, batches)) and len(out) == 3
