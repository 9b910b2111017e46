"""gRPC streaming ASR server (port of ``wenet_celoss_tpu/bin/grpc_server.py``),
wire-compatible with the reference client: the ``/wenet.ASR/Recognize``
bidi stream of ``runtime/core/grpc/wenet.proto``, over the shared C API
(``runtime/binding/python/wenet_tpu_runtime.Decoder``: feature pipeline,
the worker subprocess, search and endpointing in the native runtime).
This process is only the HTTP/2 front end. The model directory's
``worker_cmd.txt`` names the worker, for the port:

    python -m wenet_celoss_tpu_torch.bin.runtime_worker --config ... \\
        --checkpoint ... --chunk_size 16

Stream protocol (as the reference handler):
  client: Request{decode_config}          → server: Response{server_ready}
  client: Request{audio_data=PCM16 LE}*   → server: Response{partial_result}
  client: half-close (or empty audio)     → server: Response{final_result}
                                            then Response{speech_end}

The message classes are generated at first use with ``protoc`` into the
package's ``_build/`` directory (no grpcio-tools: the service uses grpc's
generic handler API with the method path and the message serializers).

    python -m wenet_celoss_tpu_torch.bin.grpc_server --model_dir DIR \\
        --port 10086
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import logging
import subprocess
import sys
from concurrent import futures
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def load_wenet_pb2():
    """Generate (once, kept by the proto's hash) and import wenet_pb2."""
    proto_dir = REPO / "runtime" / "core" / "grpc"
    digest = hashlib.sha256(
        (proto_dir / "wenet.proto").read_bytes()).hexdigest()[:16]
    out_dir = BUILD_DIR / f"pb_{digest}"
    pb2_path = out_dir / "wenet_pb2.py"
    if not pb2_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        subprocess.run(["protoc", f"--python_out={out_dir}",
                        "-I", str(proto_dir), "wenet.proto"],
                       check=True, capture_output=True)
    spec = importlib.util.spec_from_file_location("wenet_pb2", pb2_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _to_response(pb2, result, rtype):
    resp = pb2.Response(status=pb2.Response.ok, type=rtype)
    for best in result.get("nbest", []):
        ob = resp.nbest.add()
        ob.sentence = best.get("sentence", "")
        for wp in best.get("word_pieces", best.get("wordpieces", [])):
            op = ob.wordpieces.add()
            op.word = wp.get("word", "")
            op.start = int(wp.get("start", 0))
            op.end = int(wp.get("end", 0))
    return resp


def make_servicer(pb2, make_decoder):
    import grpc

    def recognize(request_iterator, context):
        dec = None
        nbest = 1
        try:
            for req in request_iterator:
                kind = req.WhichOneof("RequestPayload")
                if kind == "decode_config":
                    nbest = max(1, req.decode_config.nbest_config or 1)
                    continuous = \
                        req.decode_config.continuous_decoding_config
                    dec = make_decoder(nbest=nbest, continuous=continuous)
                    yield pb2.Response(status=pb2.Response.ok,
                                       type=pb2.Response.server_ready)
                elif kind == "audio_data":
                    if dec is None:
                        dec = make_decoder(nbest=nbest, continuous=False)
                        yield pb2.Response(status=pb2.Response.ok,
                                           type=pb2.Response.server_ready)
                    if len(req.audio_data) == 0:
                        break  # explicit end-of-audio marker
                    result = dec.decode(bytes(req.audio_data), last=False)
                    if result.get("nbest"):
                        yield _to_response(pb2, result,
                                           pb2.Response.partial_result)
            # Half-close (or an empty frame): finalize.
            if dec is not None:
                result = dec.decode(b"", last=True)
                yield _to_response(pb2, result, pb2.Response.final_result)
                yield pb2.Response(status=pb2.Response.ok,
                                   type=pb2.Response.speech_end)
        except Exception:  # noqa: BLE001 - reported as a failed status
            logging.exception("recognize stream failed")
            yield pb2.Response(status=pb2.Response.failed,
                               type=pb2.Response.speech_end)

    return grpc.method_handlers_generic_handler(
        "wenet.ASR",
        {"Recognize": grpc.stream_stream_rpc_method_handler(
            recognize,
            request_deserializer=pb2.Request.FromString,
            response_serializer=pb2.Response.SerializeToString)})


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_dir", required=True,
                    help="dir with train.yaml, units.txt and "
                         "worker_cmd.txt (the worker's command line)")
    ap.add_argument("--port", type=int, default=10086)
    ap.add_argument("--lib_path", default=None,
                    help="libwenet_tpu_api.so (default: runtime/build)")
    ap.add_argument("--chunk_size", type=int, default=16)
    ap.add_argument("--max_workers", type=int, default=8)
    args = ap.parse_args(argv)

    import grpc

    sys.path.insert(0, str(REPO / "runtime" / "binding" / "python"))
    from wenet_tpu_runtime import Decoder

    pb2 = load_wenet_pb2()

    def make_decoder(nbest=1, continuous=False):
        return Decoder(args.model_dir, lib_path=args.lib_path, nbest=nbest,
                       continuous_decoding=continuous,
                       chunk_size=args.chunk_size)

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=args.max_workers))
    server.add_generic_rpc_handlers((make_servicer(pb2, make_decoder),))
    server.add_insecure_port(f"[::]:{args.port}")
    server.start()
    logging.info("gRPC ASR server listening on %d", args.port)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
