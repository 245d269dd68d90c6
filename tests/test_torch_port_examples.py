"""PyTorch port, the example scripts (tpu_audio_torch/examples/) on the CPU:
the console's five cases of tests/test_webapp.py on its --tiny engines
(random weights), the engine tables against the reference's names
(`"funasr": STT.fun_asr`, ROADMAP C33), EngineManager's switching,
`duplex_demo --tiny`, `batch_serving`'s two runs and `tts_demo` /
`stt_demo` on miniature random models, and every module imported in a
subprocess without jax."""

import base64
import json
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401
from tpu_audio_torch.examples import batch_serving, duplex_demo, engine_manager, webapp


@pytest.fixture(scope="module")
def server():
    httpd = webapp.serve(port=0, tiny=True, poll=True, device="cpu")
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()
    httpd.server_close()


def _get(url: str, timeout=600):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def test_index_and_engine_list(server):
    code, ctype, body = _get(server + "/")
    assert code == 200 and "text/html" in ctype
    assert b"tpu-audio" in body
    code, _, body = _get(server + "/api/engines")
    d = json.loads(body)
    assert d["tts"] == ["marvis"] and d["stt"] == ["funasr"]


def test_tts_wav(server):
    code, ctype, body = _get(server + "/api/tts?engine=marvis&text=Hello%20there")
    assert code == 200 and ctype == "audio/wav"
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    n = struct.unpack("<I", body[40:44])[0]
    assert n > 0 and len(body) == 44 + n


def test_tts_stream_sse(server):
    code, ctype, body = _get(server + "/api/tts_stream?engine=marvis&text=Hi")
    assert code == 200 and "text/event-stream" in ctype
    events = [ln[len("data: "):] for ln in body.decode().splitlines()
              if ln.startswith("data: ")]
    assert json.loads(events[-1]) == {"done": True}
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks, "no audio chunks streamed"
    pcm = np.frombuffer(base64.b64decode(chunks[0]["pcm"]), np.float32)
    assert np.isfinite(pcm).all() and len(pcm) > 0


def test_stt_upload(server):
    audio = (0.1 * np.sin(np.arange(16000) / 10)).astype(np.float32)
    req = urllib.request.Request(server + "/api/stt?engine=funasr",
                                 data=webapp.wav_bytes(audio, 16000), method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        d = json.loads(r.read())
    assert "text" in d and "seconds" in d


def test_stt_rejects_garbage(server):
    req = urllib.request.Request(server + "/api/stt?engine=funasr", data=b"not a wav",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=60)
    assert err.value.code == 400


def test_engine_tables_resolve_every_reference_name():
    """Every name of the reference's tables maps to the port's factory of
    the same name: `"funasr"` to `STT.fun_asr` (C33), which the reference
    calls too."""
    import sys

    sys.path.insert(0, ".")
    from examples import engine_manager as ref
    from tpu_audio_torch.api.stt import STT
    from tpu_audio_torch.api.tts import TTS

    for table, ours, space in ((ref.TTS_ENGINES, engine_manager.TTS_ENGINES, TTS),
                               (ref.STT_ENGINES, engine_manager.STT_ENGINES, STT)):
        assert list(ours) == list(table)
        for name, fn in table.items():
            assert ours[name] is getattr(space, fn.__name__), name
    assert engine_manager.STT_ENGINES["funasr"] is STT.fun_asr


def test_engine_manager_switches_and_unloads():
    mgr = engine_manager.EngineManager()
    a = mgr.tts("orpheus", device="cpu")
    a.is_loaded = True
    b = mgr.tts("kokoro", device="cpu")
    assert mgr.active_tts == "kokoro" and not a.is_loaded and b is not a
    assert mgr.tts("kokoro") is b
    with pytest.raises(KeyError, match="unknown TTS engine 'piper'"):
        mgr.tts("piper")
    assert mgr.stt("funasr", device="cpu").quantization == "q4"
    with pytest.raises(KeyError, match="unknown STT engine"):
        engine_manager.random_stt("vosk", "cpu")
    with pytest.raises(FileNotFoundError, match="--checkpoint"):
        engine_manager.use_checkpoints("/nonexistent/cache")


def test_duplex_demo_tiny():
    lines = []
    tts, stt = duplex_demo.build_tiny("cpu")
    audio = duplex_demo.run(tts, stt, "Streaming duplex test sentence.", out=lines.append)
    assert len(audio) > 0 and np.isfinite(audio).all()
    assert any(ln.startswith("[tts ] first audio") for ln in lines)
    assert lines[-1].startswith("[done]")


def test_batch_serving_both_runs_on_tiny_models(tmp_path, capsys):
    """`stt` on two WAV files (Whisper's tiny preset, one layer, random) and
    `tts` on two texts (a miniature Orpheus): a text a clip, a WAV a text."""
    from tpu_audio_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(0)
    paths = []
    for i, secs in enumerate((3, 5)):
        p = str(tmp_path / f"clip{i}.wav")
        write_wav(p, (0.1 * rng.standard_normal(secs * 16000)).astype(np.float32), 16000)
        paths.append(p)
    texts = batch_serving.main(["--device", "cpu", "--tiny", "--layers", "1", "stt", *paths,
                                "--batch-size", "2"])
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
    results = batch_serving.main(["--device", "cpu", "--tiny", "tts", "Hello there.",
                                  "A second text.", "--max-new-tokens", "48",
                                  "--out-dir", str(tmp_path)])
    assert len(results) == 2 and all(np.isfinite(r.samples).all() for r in results)
    assert (tmp_path / "batch_out_1.wav").exists()
    assert "2 clips in" in capsys.readouterr().err


def test_tts_and_stt_demos_on_random_weights(tmp_path, monkeypatch):
    """tts_demo on the miniature Orpheus (its `random_tts` stood in by
    batch_serving's), then stt_demo on a WAV with the miniature Fun-ASR
    (`duplex_demo.build_tiny`'s; Whisper's random run is batch_serving's)."""
    from tpu_audio_torch.examples import stt_demo, tts_demo

    monkeypatch.setattr(tts_demo, "random_tts",
                        lambda name, device, seed, layers: batch_serving.tiny_orpheus(device))
    out = str(tmp_path / "out.wav")
    assert tts_demo.main(["--engine", "orpheus", "--text", "Hello.", "--device", "cpu",
                          "--out", out, "--voice", "leo", "--max-new-tokens", "48"]) == out
    from tpu_audio_torch.utils.audio_io import write_wav

    clip = str(tmp_path / "clip.wav")
    write_wav(clip, (0.1 * np.random.default_rng(1).standard_normal(32000)).astype(np.float32),
              16000)
    monkeypatch.setattr(stt_demo, "random_stt",
                        lambda name, device, **kw: duplex_demo.build_tiny(device)[1])
    res = stt_demo.main([clip, "--engine", "funasr", "--device", "cpu"])
    assert isinstance(res.text, str) and res.rtf > 0


def test_examples_import_without_jax():
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from tpu_audio_torch.examples import (batch_serving, duplex_demo, engine_manager,\n"
        "                                      stt_demo, tts_demo, webapp)\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'tpu_audio']\n"
        "print('ok')\n")
    env = {**os.environ, "PATH": "/nonexistent", "CUDA_HOME": "/nonexistent",
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
