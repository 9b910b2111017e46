"""The port's gRPC front end (``wenet_celoss_tpu_torch/bin/grpc_server.py``):
a real grpc client streams a WAV over the reference's
``/wenet.ASR/Recognize`` bidi stream to the server, whose model directory's
``worker_cmd.txt`` names the port's worker (the tiny U2++ model of
``test_torch_runtime_worker`` on the CPU). The final result equals the
one ``decoder_main`` gives with the same worker."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import grpc
import numpy as np

from test_torch_runtime_worker import (WAVS, decoder_main,  # noqa: F401
                                       runtime_build, torch_worker_cmd,
                                       write_model_dir, write_wav_scp)
from wenet_celoss_tpu_torch.bin import grpc_server
from wenet_celoss_tpu_torch.data.wav import read_audio

ROOT = Path(__file__).resolve().parent.parent
WAV = "test-clean-u008.wav"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_grpc_stream_matches_decoder_main(runtime_build, tmp_path):
    model_dir = write_model_dir(tmp_path / "model", "u2pp")
    cmd = torch_worker_cmd(model_dir)
    (model_dir / "worker_cmd.txt").write_text(cmd + "\n")
    pb2 = grpc_server.load_wenet_pb2()
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "wenet_celoss_tpu_torch.bin.grpc_server",
         "--model_dir", str(model_dir), "--port", str(port),
         "--lib_path", str(runtime_build / "libwenet_tpu_api.so"),
         "--chunk_size", "8"], env=env, stderr=subprocess.PIPE)
    try:
        chan = grpc.insecure_channel(f"127.0.0.1:{port}")
        grpc.channel_ready_future(chan).result(timeout=60)
        stub = chan.stream_stream(
            "/wenet.ASR/Recognize",
            request_serializer=pb2.Request.SerializeToString,
            response_deserializer=pb2.Response.FromString)
        wav, sr = read_audio(str(WAVS / WAV))
        pcm = np.clip(np.asarray(wav), -32768, 32767).astype(
            "<i2").tobytes()

        def requests():
            yield pb2.Request(decode_config=pb2.Request.DecodeConfig(
                nbest_config=1))
            step = int(0.5 * sr) * 2
            for i in range(0, len(pcm), step):
                yield pb2.Request(audio_data=pcm[i:i + step])

        types, finals = [], []
        for resp in stub(requests(), timeout=300):
            assert resp.status == pb2.Response.ok
            types.append(resp.type)
            if resp.type == pb2.Response.final_result:
                finals.append(resp.nbest[0].sentence if resp.nbest else "")
        chan.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
    assert types[0] == pb2.Response.server_ready
    assert types[-1] == pb2.Response.speech_end
    assert len(finals) == 1 and finals[0], types
    scp = write_wav_scp(tmp_path / "wav.scp", [WAV])
    (line,) = decoder_main(runtime_build, model_dir, scp, cmd, "default")
    assert line.split(maxsplit=1)[1] == finals[0]
