"""The port's dataset CLIs against the repo's scripts, on the CPU, at tiny
sizes (0.5 s clips, image order <= 12, 3 samples a radius or a subset).

- `python -m sound_bubble_tpu_torch.make_eval_set --device cpu` against
  `datasets/make_eval_set.py` (run by subprocess): with `--voice harmonic`,
  and with `--voice harmonic --bg_noise 1`, the two trees are the same byte
  for byte; with `--voice formant` every `metadata.json` is the same (the
  voices are torch's draws, not jax.random's);
- `python -m sound_bubble_tpu_torch.generate_adaptive_dataset` against the
  repo's `generate_adaptive_dataset.py` (by subprocess) on a mini-corpus the
  test writes (speaker dirs of 48 kHz and 16 kHz wavs, a noise dir and the
  two split files), `--n_workers 1`: the same tree, `args.json` included;
- `python -m sound_bubble_tpu_torch.pregen_pool` against
  `tools/pregen_pool.py` (by subprocess): the same file name, `_meta` and
  arrays, and `train_stream.host_pool` loads the file.

The repo's scripts run with JAX imported before they start: importing JAX
draws five numbers from numpy's global generator
(`jax/_src/clusters/k8s_cluster.py`), and the scripts import it lazily, in
the middle of their random stream (at the first background noise of
`make_eval_set.py`, at the first `snr_at_reference` of
`generate_adaptive_dataset.py`), so their trees depend on when that import
happens. The port imports everything at start."""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sound_bubble_tpu_torch import generate_adaptive_dataset as gad
from sound_bubble_tpu_torch import make_eval_set, pregen_pool, train_stream
from sound_bubble_tpu_torch.data.audio_io import write_audio_file
from sound_bubble_tpu_torch.datagen import campaign
from sound_bubble_tpu_torch.datagen.voice import formant_voices
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_ARGS = ["--n", "3", "--duration", "0.5", "--max_order_max", "12"]


def _jax_scripts(jobs):
    """Run scripts of the repo, each as `python <path> <args>` from its
    directory, one after another in one process with JAX imported first.
    jobs: [(path in the repo, args, cwd)]."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    code = ("import json, os, runpy, sys, jax\n"
            "for path, args, cwd in json.loads(sys.argv[1]):\n"
            "    os.chdir(cwd)\n"
            "    sys.argv = [path, *args]\n"
            "    runpy.run_path(path, run_name='__main__')\n")
    jobs = [(os.path.join(REPO, path), args, str(cwd))
            for path, args, cwd in jobs]
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(jobs)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


EVAL_CASES = {"harmonic": ["--voice", "harmonic"],
              "harmonic_bg": ["--voice", "harmonic", "--bg_noise", "1"],
              "formant": ["--voice", "formant"]}
POOL_ARGS = ["--n", "2", "--seed", "3", "--tag", "val", "--bg", "--sr",
             "8000", "--rir_len", "1000", "--max_order", "3"]


def _corpus(root):
    """Six speakers of three formant-voice wavs each (48 kHz, one at
    16 kHz), a noise dir of three wavs, and the two split files. Returns
    the generator's flags."""
    gen = torch.Generator().manual_seed(0)
    voices = formant_voices(gen, (6, 3), 24000, 48000).numpy()
    for s in range(6):
        spk = root / "voices" / f"p{225 + s}"
        spk.mkdir(parents=True)
        for k in range(3):
            sr = 16000 if k == 2 else 48000
            sig = voices[s, k][:sr // 2] if sr == 16000 else voices[s, k]
            write_audio_file(str(spk / f"p{225 + s}_{k:03d}.wav"),
                             0.5 * sig[None], sr)
    noise = root / "noise"
    noise.mkdir()
    rng = np.random.default_rng(1)
    for k in range(3):
        write_audio_file(str(noise / f"n{k}.wav"),
                         0.3 * rng.standard_normal((1, 24000)), 48000)
    split = {"train": [f"p{225 + s}" for s in range(4)],
             "test": ["p229", "p230"], "val": ["p225"]}
    (root / "split.json").write_text(json.dumps(split))
    (root / "noise_split.json").write_text(json.dumps(
        {"train": ["n0.wav", "n1.wav"], "test": ["n2.wav"], "val": []}))
    return [str(root / "voices"), "out", "--bg_voice_dir", str(noise),
            "--split_path", str(root / "split.json"),
            "--split_path2", str(root / "noise_split.json"),
            "--n_outputs_train", "3", "--n_outputs_test", "3",
            "--n_workers", "1", "--duration", "0.5", "--max_order_max", "12",
            "--seed", "5"]


@pytest.fixture(scope="module")
def jax_trees(tmp_path_factory):
    """The repo's scripts' outputs, made once for the module: root / the
    eval sets (one dir a case), the generator's tree and the pool cache,
    and the generator's flags."""
    root = tmp_path_factory.mktemp("jax_scripts")
    flags = _corpus(root)
    (root / "gad").mkdir()
    jobs = [("tools/pregen_pool.py",
             [*POOL_ARGS, "--cache_dir", str(root / "pool")], root),
            ("generate_adaptive_dataset.py", flags, root / "gad")]
    jobs += [("datasets/make_eval_set.py",
              ["--out", str(root / name), *EVAL_ARGS, *extra], root)
             for name, extra in EVAL_CASES.items()]
    _jax_scripts(jobs)
    return root, flags


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_make_eval_set_matches_jax(case, jax_trees, tmp_path):
    extra = EVAL_CASES[case]
    make_eval_set.main(make_eval_set.parser().parse_args(
        ["--out", str(tmp_path), *EVAL_ARGS, *extra, "--device", "cpu"]))
    got, want = _tree(tmp_path), _tree(jax_trees[0] / case)
    assert sorted(got) == sorted(want)
    metas = [k for k in want if k.endswith("metadata.json")]
    assert len(metas) == 9
    same = metas if case == "formant" else list(want)
    for k in same:
        assert got[k] == want[k], k
    if "--bg_noise" in extra:
        assert all(json.loads(want[k])["n_BG"] == 1 for k in metas)


def test_generate_adaptive_dataset_matches_jax(jax_trees, tmp_path,
                                               monkeypatch):
    root, flags = jax_trees
    monkeypatch.chdir(tmp_path)
    gad.main(gad.parser().parse_args(flags))
    got, want = _tree(tmp_path), _tree(root / "gad")
    assert sorted(got) == sorted(want)
    assert len([k for k in want if k.endswith("metadata.json")]) == 6
    assert os.path.join("out", "args.json") in want
    for k in want:
        assert got[k] == want[k], k


def test_pregen_pool_matches_jax(jax_trees, tmp_path, capsys):
    pregen_pool.main(pregen_pool.parser().parse_args(
        [*POOL_ARGS, "--cache_dir", str(tmp_path)]))
    name = "bgval_2_3.npz"
    assert os.listdir(tmp_path) == os.listdir(jax_trees[0] / "pool") == \
        [name]
    got, want = np.load(tmp_path / name), np.load(jax_trees[0] / "pool" /
                                                   name)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["_meta"], [8000, 1000, 3])
    # train_stream reads the port's file as its pool cache
    args = argparse.Namespace(pool_cache=str(tmp_path), bg_noise=0.5,
                              rir_len=1000, max_order=3,
                              require_pool_cache=True)
    pool = train_stream.host_pool(args, 2, 3, "val", 8000)
    assert "loaded cached pool" in capsys.readouterr().out
    built, _ = campaign.build_pool(2, seed=3, sr=8000, rir_len=1000,
                                   order_range=(3, 3), bg_noise=True,
                                   verbose=False)
    assert sorted(pool) == sorted(built)
    for k in built:
        np.testing.assert_array_equal(pool[k], built[k], err_msg=k)
