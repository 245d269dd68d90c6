"""Interactive TTS/STT console on 127.0.0.1: the stdlib web UI of the
reference (port of examples/webapp.py).

Engine switching across the 8 TTS and 2 STT engines, voice pickers,
streaming playback (Server-Sent Events, the page plays each chunk as it
arrives), generation and transcription timers with the real-time factor,
and WAV upload for STT.

    python -m tpu_audio_torch.examples.webapp [--tiny] [--port 7860] [--device cuda]

--tiny serves random miniature Marvis and Fun-ASR engines
(`duplex_demo.build_tiny`); otherwise each engine is built on first use,
on random weights at its published width (--layers cuts the depth), or
with --checkpoint DIR loaded from a local cache of the checkpoints. Nothing
is downloaded. stdlib only (http.server + SSE + vanilla JS).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import struct
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>tpu-audio</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:780px;margin:2rem auto;
      padding:0 1rem;color:#1a1a2e}
 h1{font-size:1.4rem} h2{font-size:1.1rem;margin-top:2rem}
 textarea{width:100%;height:5rem;font:inherit;padding:.5rem;box-sizing:border-box}
 select,button,input{font:inherit;padding:.35rem .7rem;margin:.2rem .3rem .2rem 0}
 button{cursor:pointer;background:#2d6cdf;color:#fff;border:0;border-radius:6px}
 button:disabled{background:#aaa}
 .stat{color:#555;font-size:.9rem;margin:.4rem 0}
 .seg{font-size:.95rem;margin:.15rem 0} .t{color:#888;font-size:.8rem}
 pre{background:#f4f4f8;padding:.6rem;border-radius:6px;white-space:pre-wrap}
</style></head><body>
<h1>tpu-audio — TTS / STT console</h1>

<h2>Text to speech</h2>
<div>
 engine <select id="tts_engine"></select>
 voice <select id="voice"></select>
 <label><input type="checkbox" id="stream" checked> stream</label>
</div>
<textarea id="text">The quick brown fox jumps over the lazy dog.</textarea>
<div>
 <button id="speak">Speak</button>
 <button id="stop" disabled>Stop</button>
 <span class="stat" id="tts_stat"></span>
</div>

<h2>Speech to text</h2>
<div>
 engine <select id="stt_engine"></select>
 <input type="file" id="wav" accept=".wav">
 <button id="transcribe">Transcribe</button>
 <span class="stat" id="stt_stat"></span>
</div>
<pre id="transcript"></pre>

<script>
const $=id=>document.getElementById(id);
let ctx=null, stopFlag=false, es=null;
async function init(){
  const r=await fetch('/api/engines'); const d=await r.json();
  for(const e of d.tts){const o=document.createElement('option');
    o.value=o.textContent=e;$('tts_engine').appendChild(o);}
  for(const e of d.stt){const o=document.createElement('option');
    o.value=o.textContent=e;$('stt_engine').appendChild(o);}
  $('tts_engine').value=d.default_tts; $('stt_engine').value=d.default_stt;
  loadVoices();
}
async function loadVoices(){
  const r=await fetch('/api/voices?engine='+$('tts_engine').value);
  const vs=await r.json(); const sel=$('voice'); sel.innerHTML='';
  for(const v of vs){const o=document.createElement('option');
    o.value=o.textContent=v;sel.appendChild(o);}
  sel.disabled=!vs.length;
}
$('tts_engine').onchange=loadVoices;
$('speak').onclick=async()=>{
  ctx=ctx||new AudioContext(); stopFlag=false;
  $('speak').disabled=true;$('stop').disabled=false;$('tts_stat').textContent='generating…';
  const q='engine='+$('tts_engine').value+'&voice='+
    encodeURIComponent($('voice').value||'')+'&text='+
    encodeURIComponent($('text').value);
  const t0=performance.now(); let at=ctx.currentTime+0.05, ttfa=null, dur=0;
  if($('stream').checked){
    es=new EventSource('/api/tts_stream?'+q);
    es.onmessage=(ev)=>{
      if(stopFlag){es.close();done();return;}
      const d=JSON.parse(ev.data);
      if(d.done){es.close();done();return;}
      if(ttfa===null)ttfa=(performance.now()-t0)/1000;
      const bytes=Uint8Array.from(atob(d.pcm),c=>c.charCodeAt(0));
      const f32=new Float32Array(bytes.buffer);
      const buf=ctx.createBuffer(1,f32.length,d.sr);
      buf.copyToChannel(f32,0);
      const src=ctx.createBufferSource();src.buffer=buf;src.connect(ctx.destination);
      at=Math.max(at,ctx.currentTime+0.02);src.start(at);at+=buf.duration;
      dur+=buf.duration;update();
    };
    es.onerror=()=>{es.close();done();};
  }else{
    const r=await fetch('/api/tts?'+q);const ab=await r.arrayBuffer();
    ttfa=(performance.now()-t0)/1000;
    const buf=await ctx.decodeAudioData(ab);dur=buf.duration;
    const src=ctx.createBufferSource();src.buffer=buf;
    src.connect(ctx.destination);src.start();update();done();
  }
  function update(){const el=(performance.now()-t0)/1000;
    $('tts_stat').textContent=el.toFixed(2)+'s · audio '+dur.toFixed(2)+
      's · RTF '+(dur?(el/dur).toFixed(3):'—')+' · TTFA '+
      (ttfa!==null?ttfa.toFixed(2)+'s':'—');}
  function done(){$('speak').disabled=false;$('stop').disabled=true;}
};
$('stop').onclick=async()=>{stopFlag=true;await fetch('/api/stop',{method:'POST'});};
$('transcribe').onclick=async()=>{
  const f=$('wav').files[0];if(!f){alert('choose a wav file');return;}
  $('stt_stat').textContent='transcribing…';
  const t0=performance.now();
  const r=await fetch('/api/stt?engine='+$('stt_engine').value,
    {method:'POST',body:await f.arrayBuffer()});
  const d=await r.json();
  $('stt_stat').textContent=((performance.now()-t0)/1000).toFixed(2)+'s';
  $('transcript').textContent=d.text+'\\n\\n'+(d.segments||[]).map(
    s=>'['+s.start.toFixed(2)+'–'+s.end.toFixed(2)+'] '+s.text).join('\\n');
};
init();
</script></body></html>"""


def wav_bytes(samples: np.ndarray, sr: int) -> bytes:
    pcm = np.clip(samples, -1, 1)
    pcm = (pcm * 32767).astype("<i2").tobytes()
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE",
                      b"fmt ", 16, 1, 1, sr, sr * 2, 2, 16, b"data", len(pcm))
    return hdr + pcm


def read_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    import wave

    with wave.open(io.BytesIO(data)) as w:
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        width, ch = w.getsampwidth(), w.getnchannels()
    if width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


class AppState:
    """Engine registry and the one-generation-at-a-time policy of the
    reference's playback controller (stop cancels the active stream)."""

    def __init__(self, tiny: bool, device="cuda", checkpoint: str | None = None,
                 layers: int | None = None):
        from tpu_audio_torch.examples import engine_manager as em

        self.tiny, self.device, self.checkpoint, self.layers = tiny, device, checkpoint, layers
        self.lock = threading.Lock()  # engines serialise generation
        self._tts = {}
        self._stt = {}
        if tiny:
            from tpu_audio_torch.examples.duplex_demo import build_tiny

            tts, stt = build_tiny(device)
            self._tts["marvis"] = tts
            self._stt["funasr"] = stt
            self.tts_names = ["marvis"]
            self.stt_names = ["funasr"]
        else:
            if checkpoint:
                em.use_checkpoints(checkpoint)
            self.tts_names = sorted(em.TTS_ENGINES)
            self.stt_names = sorted(em.STT_ENGINES)

    def tts(self, name: str):
        from tpu_audio_torch.examples import engine_manager as em

        if name not in self._tts:
            self._tts[name] = (em.TTS_ENGINES[name](device=self.device) if self.checkpoint
                               else em.random_tts(name, self.device, layers=self.layers))
        eng = self._tts[name]
        if not eng.is_loaded:
            eng.load()
        return eng

    def stt(self, name: str):
        from tpu_audio_torch.examples import engine_manager as em

        if name not in self._stt:
            self._stt[name] = (em.STT_ENGINES[name](device=self.device) if self.checkpoint
                               else em.random_stt(name, self.device, layers=self.layers))
        eng = self._stt[name]
        if hasattr(eng, "is_loaded") and not eng.is_loaded:
            eng.load()
        return eng

    def voices(self, name: str) -> list[str]:
        if name == "kokoro":
            from tpu_audio_torch.models.kokoro.voices import VOICES

            return sorted(VOICES)
        if name == "orpheus":
            from tpu_audio_torch.models.orpheus.model import VOICES

            return list(VOICES)
        return []


class Handler(BaseHTTPRequestHandler):
    state: AppState = None  # set by serve()

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code=200):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        q = dict(urllib.parse.parse_qsl(url.query))
        if url.path == "/":
            self._send(200, PAGE.encode(), "text/html; charset=utf-8")
        elif url.path == "/api/engines":
            self._json({"tts": self.state.tts_names,
                        "stt": self.state.stt_names,
                        "default_tts": self.state.tts_names[0],
                        "default_stt": self.state.stt_names[0]})
        elif url.path == "/api/voices":
            self._json(self.state.voices(q.get("engine", "")))
        elif url.path == "/api/tts":
            self._tts_once(q)
        elif url.path == "/api/tts_stream":
            self._tts_stream(q)
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):
        url = urllib.parse.urlparse(self.path)
        q = dict(urllib.parse.parse_qsl(url.query))
        if url.path == "/api/stt":
            n = int(self.headers.get("Content-Length", "0"))
            data = self.rfile.read(n)
            try:
                audio, sr = read_wav_bytes(data)
            except Exception as e:
                self._json({"error": f"bad wav: {e}"}, 400)
                return
            with self.state.lock:
                eng = self.state.stt(q.get("engine",
                                           self.state.stt_names[0]))
                t0 = time.perf_counter()
                res = eng.transcribe(audio if sr == 16000 else
                                     _resample(audio, sr))
            self._json({
                "text": res.text,
                "seconds": time.perf_counter() - t0,
                "segments": [
                    {"start": float(s.start), "end": float(s.end),
                     "text": s.text}
                    for s in (getattr(res, "segments", None) or [])]})
        elif url.path == "/api/stop":
            for eng in self.state._tts.values():
                try:
                    eng.stop()
                except Exception:
                    pass
            self._json({"ok": True})
        else:
            self._json({"error": "not found"}, 404)

    # ------------------------------------------------------------ tts paths

    def _engine_kwargs(self, q):
        kw = {}
        if q.get("voice"):
            kw["voice"] = q["voice"]
        return kw

    def _tts_once(self, q):
        with self.state.lock:
            eng = self.state.tts(q.get("engine", self.state.tts_names[0]))
            if q.get("voice") and hasattr(eng, "voice"):
                eng.voice = q["voice"]
            res = eng.generate(q.get("text", ""))
        self._send(200, wav_bytes(res.samples, res.sample_rate), "audio/wav")

    def _tts_stream(self, q):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            with self.state.lock:
                eng = self.state.tts(q.get("engine",
                                           self.state.tts_names[0]))
                if q.get("voice") and hasattr(eng, "voice"):
                    eng.voice = q["voice"]
                for chunk in eng.generate_streaming(q.get("text", "")):
                    if not len(chunk.samples):
                        continue
                    pcm = base64.b64encode(
                        np.asarray(chunk.samples,
                                   np.float32).tobytes()).decode()
                    msg = json.dumps({"pcm": pcm, "sr": chunk.sample_rate})
                    self.wfile.write(f"data: {msg}\n\n".encode())
                    self.wfile.flush()
            self.wfile.write(b'data: {"done": true}\n\n')
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            try:
                eng.stop()
            except Exception:
                pass


def _resample(audio, sr):
    from tpu_audio_torch.ops.resample import resample

    return resample(audio, sr, 16000)


def serve(port: int, tiny: bool, poll: bool = False, device="cuda",
          checkpoint: str | None = None, layers: int | None = None):
    """Serve the console on 127.0.0.1:port (0: any free port). poll: return
    the server without serving, for a caller that runs it."""
    Handler.state = AppState(tiny, device, checkpoint, layers)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    print(f"tpu-audio console: http://127.0.0.1:{httpd.server_address[1]}/"
          f"{'  (tiny random-weight engines)' if tiny else ''}", flush=True)
    if poll:
        return httpd
    httpd.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random-weight engines (no downloads)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default=None,
                    help="a local cache of the checkpoints (the Hugging Face layout)")
    ap.add_argument("--layers", type=int, default=None,
                    help="random weights: cut the depth to this many layers")
    serve(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
