"""Port's keyword-data tools (honk_tpu_torch.datagen, cli.manage_audio) against the JAX package, on the CPU.

Mirrors ``tests/test_datagen.py`` and ``tests/test_manage_audio.py`` case for
case on the port, and holds each stage against the JAX package on the same
inputs: parsed captions and occurrences equal, clip files and trimmed or
windowed WAVs byte-equal, and the quality report of ``zoo/res8.pt`` equal in
verdicts with probabilities within 1e-4 (``evaluate_clips`` at
``batch_size=8``, and the whole CLI with ``--eval_checkpoint``).
"""

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from honk_tpu import datagen as J
from honk_tpu.cli.manage_audio import main as jmanage_main
from honk_tpu.datagen.cli import main as jdatagen_main
from honk_tpu_torch import datagen as G
from honk_tpu_torch.cli.demo import synthesize_long_audio
from honk_tpu_torch.cli.manage_audio import main
from honk_tpu_torch.data.wavio import read_wav, write_wav
from honk_tpu_torch.datagen.cli import main as datagen_main

SR = 16000
ROOT = Path(__file__).resolve().parents[1]
ZOO_RES8 = str(ROOT / "zoo" / "res8.pt")
# Softmax probabilities of one checkpoint on the same clips (logits within
# the reference's 2e-4 gate).
PROB_ATOL = 1e-4

SRT = """\
1
00:00:01,000 --> 00:00:03,000
yes we can go

2
00:00:05,500 --> 00:00:06,500
no

3
00:00:10,000 --> 00:00:10,000
degenerate block yes
"""

VTT = """\
WEBVTT

00:01.000 --> 00:03.000
<c>yes</c> we can go

note-cue
00:05.500 --> 00:06.500
no
"""


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread, so test processes on one host do not starve
    each other's OpenMP workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_parse_srt():
    caps = G.parse_srt(SRT)
    assert len(caps) == 3
    assert caps[0].start == 1.0 and caps[0].end == 3.0
    assert caps[0].text == "yes we can go"
    assert caps[1].text == "no"
    assert [tuple(c) for c in caps] == [tuple(c) for c in J.parse_srt(SRT)]


def test_parse_vtt_strips_tags_and_header():
    caps = G.parse_vtt(VTT)
    assert len(caps) == 2
    assert caps[0].text.startswith("yes")
    assert caps[0].start == 1.0
    assert caps[1].start == 5.5
    assert [tuple(c) for c in caps] == [tuple(c) for c in J.parse_vtt(VTT)]


def test_find_keyword_occurrences_interpolates():
    caps = G.parse_srt(SRT)
    occs = G.find_keyword_occurrences(caps, ["yes", "no"])
    # 'yes' in block 1 (word 0 of 4 over [1,3] -> starts at 1.0);
    # 'no' in block 2; block 3 is degenerate (end==start) and dropped.
    assert [o.keyword for o in occs] == ["yes", "no"]
    assert occs[0].start == pytest.approx(1.0)
    assert occs[0].end <= occs[0].start + 1.0
    assert occs[1].start == pytest.approx(5.5)
    want = J.find_keyword_occurrences(J.parse_srt(SRT), ["yes", "no"])
    assert [tuple(o) for o in occs] == [tuple(o) for o in want]


def _tone(freq, dur_s, amp=0.5):
    t = np.arange(int(dur_s * SR)) / SR
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _make_video(root):
    """20 s of near-silence with loud tones at caption-aligned times (tests/test_datagen.py's)."""
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(20 * SR) * 0.002).astype(np.float32)
    # 'yes' spoken at ~1.0-1.5 s, 'no' at ~5.5-6.0 s (match SRT timing).
    audio[SR : SR + SR // 2] += _tone(440, 0.5)
    audio[int(5.5 * SR) : int(5.5 * SR) + SR // 2] += _tone(880, 0.5)
    write_wav(os.path.join(root, "vid0.wav"), audio, SR)
    with open(os.path.join(root, "vid0.srt"), "w") as f:
        f.write(SRT)
    return audio


def _srt_time(t):
    ms = int(round(t * 1000))
    return f"{ms // 3600000:02d}:{ms // 60000 % 60:02d}:{ms // 1000 % 60:02d},{ms % 1000:03d}"


def _make_keyword_track(root, stem="track", seconds=30, seed=7):
    """Generator keywords planted at known times in noise (the streaming
    tests' track), one caption per keyword at its planted second, plus one
    caption naming a word the model has no label for."""
    words = ["yes", "stop", "go", "left", "no", "right"]
    track, positions = synthesize_long_audio(words, seconds=seconds, seed=seed, gap_s=3.0, noise_amp=0.01)
    write_wav(os.path.join(root, f"{stem}.wav"), track, SR)
    blocks = [f"{i + 1}\n{_srt_time(t)} --> {_srt_time(t + 1.0)}\n{w}\n" for i, (t, w) in enumerate(positions)]
    t = positions[-1][0] + 2.0
    blocks.append(f"{len(blocks) + 1}\n{_srt_time(t)} --> {_srt_time(t + 1.0)}\nbanana\n")
    with open(os.path.join(root, f"{stem}.srt"), "w") as f:
        f.write("\n".join(blocks))
    return words + ["banana"]


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(dp, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_extract_and_write_clips(tmp_path):
    src_root = str(tmp_path / "src")
    out_root = str(tmp_path / "out")
    os.makedirs(src_root)
    _make_video(src_root)

    items = list(G.LocalFileSource(src_root))
    assert len(items) == 1 and items[0].source_id == "vid0"
    occs = G.find_keyword_occurrences(items[0].captions, ["yes", "no"])
    clips = G.extract_clips(items[0].audio, occs)
    assert {c.keyword for c in clips} == {"yes", "no"}
    for c in clips:
        assert c.audio.shape == (16000,)
        # RMS recentering must land the window on the loud tone.
        assert np.abs(c.audio).max() > 0.2

    paths = G.write_clips(clips, out_root, "vid0")
    assert all("_nohash_" in p for p in paths)
    for p in paths:
        data, sr = read_wav(p)
        assert sr == SR and data.shape == (16000,)
    # honk directory layout: <word>/<source>_nohash_<n>.wav
    assert os.path.exists(os.path.join(out_root, "yes", "vid0_nohash_0.wav"))
    assert os.path.exists(os.path.join(out_root, "no", "vid0_nohash_0.wav"))

    # The JAX stages on the same source: the same clips, the same file bytes.
    jitem = next(iter(J.LocalFileSource(src_root)))
    for recenter in (True, False):
        jclips = J.extract_clips(jitem.audio, J.find_keyword_occurrences(jitem.captions, ["yes", "no"]),
                                 recenter=recenter)
        pclips = G.extract_clips(items[0].audio, occs, recenter=recenter)
        assert [(c.keyword, c.source_time) for c in pclips] == [(c.keyword, c.source_time) for c in jclips]
        for p, j in zip(pclips, jclips):
            assert p.audio.dtype == j.audio.dtype and np.array_equal(p.audio, j.audio)
    J.write_clips(jclips, str(tmp_path / "jout"), "vid0")
    G.write_clips(pclips, str(tmp_path / "pout"), "vid0")
    assert _tree(str(tmp_path / "pout")) == _tree(str(tmp_path / "jout"))


def test_quality_report(tmp_path):
    """A freshly-initialized model yields a structurally-correct report."""
    from honk_tpu_torch.models import find_config, find_model, init_weights
    from honk_tpu_torch.serve.service import default_labels

    src_root = str(tmp_path / "src")
    os.makedirs(src_root)
    _make_video(src_root)
    item = next(iter(G.LocalFileSource(src_root)))
    occs = G.find_keyword_occurrences(item.captions, ["yes", "no"])
    clips = G.extract_clips(item.audio, occs)

    labels = default_labels()
    cfg = find_config("res8-narrow")
    cfg["n_labels"] = len(labels)
    model = init_weights(find_model("res8-narrow")(cfg), torch.Generator().manual_seed(0)).eval()

    report = G.evaluate_clips(model, None, labels, clips, batch_size=8)
    assert report["n_clips"] == len(clips) and report["n_scored"] == len(clips)
    assert set(report["per_keyword"]) == {"yes", "no"}
    for stats in report["per_keyword"].values():
        assert 0.0 <= stats["acceptance"] <= 1.0
        assert stats["total"] >= 1
    assert len(report["verdicts"]) == len(clips)
    with pytest.raises(ValueError, match="eval mode"):
        G.evaluate_clips(model.train(), None, labels, clips)


def _same_report(got, want):
    """Equal keys, counts and verdicts (pred, accept); probabilities within PROB_ATOL."""
    assert {k: v for k, v in got.items() if k != "verdicts"} == {k: v for k, v in want.items() if k != "verdicts"}
    assert len(got["verdicts"]) == len(want["verdicts"])
    for g, w in zip(got["verdicts"], want["verdicts"]):
        assert {k: g[k] for k in ("keyword", "source_time", "pred", "accept")} == \
            {k: w[k] for k in ("keyword", "source_time", "pred", "accept")}
        assert abs(g["prob"] - w["prob"]) <= PROB_ATOL and abs(g["keyword_prob"] - w["keyword_prob"]) <= PROB_ATOL


def test_quality_report_matches_jax_on_res8(tmp_path):
    """zoo/res8.pt on the planted keywords (two batches of 8, the second padded), and an
    unknown keyword: the JAX report's verdicts, probabilities within 1e-4."""
    from honk_tpu.serve.service import LabelService as JLabelService
    from honk_tpu_torch.serve import LabelService

    src = str(tmp_path / "src")
    os.makedirs(src)
    words = _make_keyword_track(src, seconds=30, seed=7) + _make_keyword_track(src, "track2", seconds=30, seed=8)
    clips = []
    for item in G.LocalFileSource(src):
        clips += G.extract_clips(item.audio, G.find_keyword_occurrences(item.captions, words))
    assert len(clips) == 14
    jsvc = JLabelService("res8", ZOO_RES8)
    want = J.evaluate_clips(jsvc.model, jsvc.variables, jsvc.labels, clips, batch_size=8)
    svc = LabelService("res8", ZOO_RES8, device="cpu")
    got = G.evaluate_clips(svc.model, None, svc.labels, clips, batch_size=8)
    _same_report(got, want)
    assert got["unknown_keywords"] == ["banana"] and got["n_scored"] == 12
    assert sum(v["accept"] for v in got["verdicts"]) >= 10  # the planted keywords are found
    # The weights given as a state dict score the same as the model's own.
    sd = torch.load(ZOO_RES8, map_location="cpu", weights_only=True)
    model = LabelService("res8", ZOO_RES8, device="cpu").model
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    assert G.evaluate_clips(model, sd, svc.labels, clips, batch_size=8) == got


def test_youtube_source_fails_actionably():
    with pytest.raises(RuntimeError, match="LocalFileSource"):
        G.YouTubeSource(["yes"])


def test_datagen_cli(tmp_path, capsys):
    src_root = str(tmp_path / "src")
    out_root = str(tmp_path / "out")
    os.makedirs(src_root)
    _make_video(src_root)
    rc = datagen_main(["--keywords", "yes", "no", "--source", "local",
                       "--input_dir", src_root, "--out_dir", out_root])
    assert rc == 0
    out = capsys.readouterr().out
    assert "vid0" in out and "total:" in out
    assert os.path.exists(os.path.join(out_root, "yes"))


def test_datagen_cli_eval_matches_jax_cli(tmp_path, capsys):
    """The whole CLI with --eval_checkpoint zoo/res8.pt: the same clip files,
    stdout lines and report as the JAX CLI's (probabilities within 1e-4)."""
    src = str(tmp_path / "src")
    os.makedirs(src)
    words = _make_keyword_track(src)
    runs = {}
    for side, fn, extra in (("jax", jdatagen_main, []), ("port", datagen_main, ["--device", "cpu"])):
        out_dir, report = str(tmp_path / f"out-{side}"), str(tmp_path / f"report-{side}.json")
        rc = fn(["--keywords", *words, "--input_dir", src, "--out_dir", out_dir,
                 "--eval_checkpoint", ZOO_RES8, "--report_json", report, *extra])
        assert rc == 0
        with open(report) as f:
            runs[side] = (_tree(out_dir), capsys.readouterr().out.replace(out_dir, "<out_dir>"), json.load(f))
    assert runs["port"][0] == runs["jax"][0] and len(runs["port"][0]) == 7
    head = lambda out: out.split("{", 1)[0]  # noqa: E731 (the per-source and total lines)
    assert head(runs["port"][1]) == head(runs["jax"][1]) == \
        "track: 7 occurrences -> 7 clips\ntotal: 1 sources, 7 clips -> <out_dir>\n"
    _same_report(runs["port"][2], runs["jax"][2])


def test_datagen_cli_refuses_orbax_and_missing_cuda(tmp_path, capsys, monkeypatch):
    src = str(tmp_path / "src")
    os.makedirs(src)
    _make_video(src)
    argv = ["--keywords", "yes", "--input_dir", src, "--out_dir", str(tmp_path / "out")]
    with monkeypatch.context() as m:  # a directory that holds no Orbax checkpoint (tensorstore is not needed)
        m.setitem(sys.modules, "tensorstore", None)
        with pytest.raises(SystemExit) as e:
            datagen_main(argv + ["--eval_checkpoint", str(ROOT / "zoo"), "--device", "cpu"])
    assert e.value.code == 2 and "is neither a .pt file nor an Orbax checkpoint" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            datagen_main(argv + ["--eval_checkpoint", ZOO_RES8])
    assert not os.path.exists(tmp_path / "out")  # refused before any clip is written


# ---- manage_audio (mirrors tests/test_manage_audio.py) ----
def _write_padded_tone(path, lead=4000, body=8000):
    sig = np.zeros(lead + body + lead, np.float32)
    t = np.arange(body) / 16000.0
    sig[lead : lead + body] = 0.5 * np.sin(2 * np.pi * 440 * t)
    write_wav(path, sig, 16000)


def test_trim_shortens_silence(tmp_path, capsys):
    d = str(tmp_path)
    _write_padded_tone(os.path.join(d, "a.wav"))
    rc = main(["trim", d, "--threshold", "0.01"])
    assert rc in (0, None)
    data, sr = read_wav(os.path.join(d, "a.wav"))
    assert sr == 16000
    assert data.shape[0] < 16000  # leading/trailing silence removed
    assert np.abs(data).max() > 0.4  # tone kept


def test_window_keeps_max_energy(tmp_path):
    d = str(tmp_path)
    _write_padded_tone(os.path.join(d, "a.wav"), lead=12000, body=8000)
    main(["window", d, "--size", "8000"])
    data, _ = read_wav(os.path.join(d, "a.wav"))
    assert data.shape[0] == 8000
    assert np.sqrt(np.mean(data**2)) > 0.2  # landed on the tone


def test_synth_and_info(tmp_path, capsys):
    d = str(tmp_path / "corpus")
    main(["synth", d, "--clips", "2"])
    wavs = [
        os.path.join(dp, f)
        for dp, _, fs in os.walk(d)
        for f in fs
        if f.endswith(".wav")
    ]
    assert len(wavs) > 10
    capsys.readouterr()
    main(["info", wavs[0]])
    out = capsys.readouterr().out
    assert "rms" in out or "dur" in out or wavs[0] in out
    jmanage_main(["info", wavs[0]])
    assert capsys.readouterr().out == out


@pytest.mark.parametrize("argv", [["trim"], ["trim", "--threshold", "0.05"], ["window"], ["window", "--size", "8000"]])
def test_manage_audio_writes_the_jax_clis_bytes(tmp_path, argv, capsys):
    """trim / window on copies of one directory (nested, seeded clips of
    several lengths, one all quiet): every file byte-equal to the JAX CLI's."""
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    rng = np.random.default_rng(len(argv))
    for i, n in enumerate((6000, 16000, 23000, 40000)):
        x = (rng.standard_normal(n) * 0.004).astype(np.float32)
        lo = int(rng.integers(0, n // 2))
        x[lo : lo + n // 4] += (rng.standard_normal(n // 4) * 0.3).astype(np.float32)
        write_wav(str(src / ("sub" if i % 2 else ".") / f"c{i}.wav"), x, SR)
    write_wav(str(src / "quiet.wav"), np.zeros(8000, np.float32), SR)
    for side in ("jax", "port"):
        shutil.copytree(src, tmp_path / side)
    assert jmanage_main([argv[0], str(tmp_path / "jax"), *argv[1:]]) == 0
    jout = capsys.readouterr().out
    assert main([argv[0], str(tmp_path / "port"), *argv[1:]]) == 0
    assert capsys.readouterr().out == jout
    got, want = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert got == want and got != _tree(str(src))
