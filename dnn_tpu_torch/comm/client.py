"""Synchronous client for a NodeService endpoint (the subset of
dnn_tpu/comm/client.NodeClient this port needs): health checks,
`send_tensor` into a stage pipeline, and unary and streaming generation
from the LM daemon over the same wire and the same request-id option
grammar ("gen:max_new[:seed][:t=..][:k=..][:p=..][:m=..][:r=..]")."""

from __future__ import annotations

import time
from typing import Optional, Tuple

import grpc
import numpy as np
import torch

from dnn_tpu_torch.comm import wire_pb2 as pb
from dnn_tpu_torch.comm import wirecodec as wc
from dnn_tpu_torch.comm.service import (
    GRPC_MSG_OPTIONS,
    PER_STAGE_BUDGET_S,
    RETRYABLE_CODES,
    SERVICE_NAME,
    _tensor_arr,
    _tensor_msg,
    full_jitter_delay,
    tag_deadline,
)


def pipeline_budget(num_parts: int, *, margin: float = 30.0) -> float:
    """The edge client's budget for one traversal of a gRPC pipeline: one
    per-stage slice per part plus a margin, so it outlasts the first
    stage's own forward budget and a downstream timeout comes back as
    that stage's status, not as the client's DEADLINE_EXCEEDED."""
    return PER_STAGE_BUDGET_S * num_parts + margin


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
    """Sync client for a NodeService endpoint. Plain gRPC, no transport
    negotiation; only send_tensor retries (generate raises
    grpc.RpcError at once)."""

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

    def send_tensor(self, arr, *, request_id: str = "req",
                    timeout: float = 60.0, retries: int = 2,
                    backoff: float = 0.2
                    ) -> Tuple[str, Optional[torch.Tensor]]:
        """Submit an activation (numpy array or tensor) to a stage
        server; returns (status, final tensor or None) from the response
        chain. UNAVAILABLE, RESOURCE_EXHAUSTED and DATA_LOSS are retried
        up to `retries` times with full-jitter backoff; `timeout` is the
        budget of all attempts together, and each attempt carries what is
        left of it as the request's `dl=` deadline."""
        call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/SendTensor",
            request_serializer=wc.serialize_request,
            response_deserializer=wc.parse_response)
        request = wc.TensorRequest(request_id=request_id,
                                   tensor=_tensor_msg(arr))
        deadline = time.monotonic() + timeout
        attempt = 0
        while True:
            remaining = deadline - time.monotonic()
            request.request_id = tag_deadline(request_id, remaining)
            try:
                resp = call(request, timeout=max(remaining, 0.001))
                result = (wc.tensor_torch(resp.result_tensor)
                          if resp.HasField("result_tensor") else None)
                return resp.status, result
            except (grpc.RpcError, wc.PayloadCorruptError) as e:
                code = (e.code() if isinstance(e, grpc.RpcError)
                        else grpc.StatusCode.DATA_LOSS)
                worst = backoff * (2 ** attempt)
                if (code not in RETRYABLE_CODES or attempt >= retries
                        or deadline - time.monotonic() <= worst):
                    raise
                time.sleep(full_jitter_delay(backoff, attempt))
                attempt += 1

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
