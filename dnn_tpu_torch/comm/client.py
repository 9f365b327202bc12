"""Minimal synchronous client for the LM daemon (the subset of
dnn_tpu/comm/client.NodeClient this port needs): health checks, unary
generation and streaming generation over the same wire and the same
request-id option grammar ("gen:max_new[:seed][:t=..][:k=..][:p=..]
[:m=..][:r=..]")."""

from __future__ import annotations

import time
from typing import Optional

import grpc
import numpy as np

from dnn_tpu_torch.comm import wire_pb2 as pb
from dnn_tpu_torch.comm import wirecodec as wc
from dnn_tpu_torch.comm.service import (
    GRPC_MSG_OPTIONS,
    SERVICE_NAME,
    _tensor_arr,
    _tensor_msg,
)


def gen_request_id(max_new_tokens: int, seed: Optional[int] = None,
                   temperature: Optional[float] = None,
                   top_k: Optional[int] = None,
                   top_p: Optional[float] = None,
                   min_p: Optional[float] = None,
                   repetition_penalty: Optional[float] = None) -> str:
    """Encode generation options into the request_id the daemon parses
    (runtime/lm_server.parse_gen_options)."""
    rid = f"gen:{max_new_tokens}" + (f":{seed}" if seed is not None else "")
    for key, val in (("t", temperature), ("k", top_k), ("p", top_p),
                     ("m", min_p), ("r", repetition_penalty)):
        if val is not None:
            rid += f":{key}={val}"
    return rid


class NodeClient:
    """Sync client for a NodeService endpoint. Plain gRPC; no transport
    negotiation, no retries (a failed call raises grpc.RpcError)."""

    def __init__(self, address: str):
        self.address = address
        self._channel = grpc.insecure_channel(address,
                                              options=GRPC_MSG_OPTIONS)

    def health_check(self, timeout: float = 5.0) -> bool:
        call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/HealthCheck",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.HealthCheckResponse.FromString)
        try:
            return bool(call(pb.Empty(), timeout=timeout).is_healthy)
        except grpc.RpcError:
            return False

    def wait_healthy(self, deadline: float = 30.0,
                     interval: float = 0.2) -> bool:
        """Poll HealthCheck until healthy or `deadline` seconds pass."""
        t_end = time.monotonic() + deadline
        while not self.health_check(timeout=min(5.0, interval * 4)):
            if time.monotonic() >= t_end:
                return False
            time.sleep(interval)
        return True

    def generate(self, prompt_ids, *, max_new_tokens: int = 32,
                 timeout: float = 120.0, **options) -> np.ndarray:
        """Prompt token ids -> generated tokens (SendTensor). `options`
        are gen_request_id's keywords (seed, temperature, top_k, ...)."""
        call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/SendTensor",
            request_serializer=wc.serialize_request,
            response_deserializer=wc.parse_response)
        req = wc.TensorRequest(
            request_id=gen_request_id(max_new_tokens, **options),
            tensor=_tensor_msg(np.asarray(prompt_ids, np.int32).reshape(-1)))
        resp = call(req, timeout=timeout)
        if not resp.HasField("result_tensor"):
            raise RuntimeError(f"LM server returned no tokens: {resp.status}")
        return np.asarray(_tensor_arr(resp.result_tensor), np.int32)

    def generate_stream(self, prompt_ids, *, max_new_tokens: int = 32,
                        timeout: float = 120.0, **options):
        """Yield each generated token as the server commits it
        (GenerateStream). Abandoning the iterator cancels the RPC, which
        frees the server's decode slot."""
        call = self._channel.unary_stream(
            f"/{SERVICE_NAME}/GenerateStream",
            request_serializer=wc.serialize_request,
            response_deserializer=wc.parse_response)
        stream = call(
            wc.TensorRequest(
                request_id=gen_request_id(max_new_tokens, **options),
                tensor=_tensor_msg(
                    np.asarray(prompt_ids, np.int32).reshape(-1))),
            timeout=timeout)
        try:
            for resp in stream:
                if resp.HasField("result_tensor"):
                    yield int(_tensor_arr(resp.result_tensor)[0])
        finally:
            stream.cancel()

    def close(self):
        self._channel.close()
