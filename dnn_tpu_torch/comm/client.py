"""Synchronous client for a NodeService endpoint (the subset of
dnn_tpu/comm/client.NodeClient this port needs): health checks, the
transport hello, `send_tensor` into a stage pipeline and `send_tensors`
over the streamed Relay RPC, unary and streaming generation from the LM
daemon over the same wire and the same request-id option grammar
("gen:max_new[:seed][:t=..][:k=..][:p=..][:m=..][:r=..]"), and its text
front over SendMessage."""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import grpc
import numpy as np
import torch

from dnn_tpu_torch import native
from dnn_tpu_torch.comm import transport as tx
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
)
from dnn_tpu_torch.comm.transport import tag_deadline


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
    """Sync client for a NodeService endpoint of either package (or a
    reference node). The first `send_tensors` sends the transport hello,
    which tells whether the peer speaks Relay. Only send_tensor retries
    (generate and send_tensors raise grpc.RpcError at once)."""

    def __init__(self, address: str):
        native.load()  # the checksum library, built before the first call
        self.address = address
        self._channel = grpc.insecure_channel(address,
                                              options=GRPC_MSG_OPTIONS)
        self._negotiated: Optional[tx.Negotiated] = None
        self._neg_lock = threading.Lock()

    def health_check(self, timeout: float = 5.0) -> bool:
        call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/HealthCheck",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.HealthCheckResponse.FromString)
        try:
            return bool(call(pb.Empty(), timeout=timeout).is_healthy)
        except grpc.RpcError:
            return False

    def send_message(self, sender_id: str, text: str,
                     timeout: float = 5.0) -> str:
        """SendMessage: the reply's confirmation text."""
        call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/SendMessage",
            request_serializer=pb.MessageRequest.SerializeToString,
            response_deserializer=pb.MessageReply.FromString)
        return call(pb.MessageRequest(sender_id=sender_id, message_text=text),
                    timeout=timeout).confirmation_text

    def negotiated(self) -> tx.Negotiated:
        """The hop's handshake outcome, negotiated once. A failed hello
        (the peer not up yet) gives an uncached grpc verdict that leaves
        Relay to be tried; a peer without SendMessage a cached one
        without Relay."""
        with self._neg_lock:
            if self._negotiated is not None:
                return self._negotiated
            try:
                neg = tx.negotiate_over(
                    lambda sid, text: self.send_message(sid, text, 10.0))
            except grpc.RpcError as e:
                if e.code() != grpc.StatusCode.UNIMPLEMENTED:
                    return tx.Negotiated("grpc", tx.GrpcSender(),
                                         reason=f"hello failed: {e.code()}")
                neg = tx.Negotiated("grpc", tx.GrpcSender(), relay_known=True,
                                    reason="no SendMessage")
            self._negotiated = neg
            return neg

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

    def send_tensors(self, arrs, *, request_id: str = "req",
                     timeout: float = 120.0,
                     ack_s: Optional[List[Optional[float]]] = None
                     ) -> List[Tuple[str, Optional[torch.Tensor]]]:
        """Submit microbatches over the streamed Relay RPC: the first
        stage acks each as soon as it accepts it and computes the next
        while the later stages work, and payloads above CHUNK_BYTES ride
        in chunks. Returns [(status, result or None)] in submission
        order. Never retried once the stream has begun (the acks released
        the items); a peer without Relay (its hello says so, or the call
        answers UNIMPLEMENTED) gets sequential unary send_tensor calls
        instead. `timeout` covers the whole stream. A list passed as
        `ack_s` is filled, as the acks come, with each item's seconds from
        its submission to its ack (None where no ack came)."""
        arrs = list(arrs)
        if ack_s is None:
            ack_s = []
        ack_s[:] = [None] * len(arrs)
        if not arrs:
            return []
        request_id = tag_deadline(request_id, timeout)
        neg = self.negotiated()
        if neg.relay_known and not neg.relay_ok:
            return self._send_each(arrs, request_id, timeout)
        sent_at = {}

        def frames():
            for seq, arr in enumerate(arrs):
                req = neg.sender.make_request(arr, request_id)
                sent_at[seq] = time.perf_counter()
                yield from tx.split_requests(req, seq)

        call = self._channel.stream_stream(
            f"/{SERVICE_NAME}/Relay",
            request_serializer=wc.serialize_request,
            response_deserializer=wc.parse_response)
        results: dict = {}
        stream = call(frames(), timeout=timeout)
        try:
            for resp in stream:
                seq = tx.parse_ack(resp.status)
                if seq is not None:
                    if 0 <= seq < len(arrs) and seq in sent_at:
                        ack_s[seq] = time.perf_counter() - sent_at[seq]
                    continue
                seq, human = tx.parse_result(resp.status)
                if seq is None or seq < 0:
                    raise RuntimeError(f"relay stream error: {human}")
                results[seq] = (human, wc.tensor_torch(resp.result_tensor)
                                if resp.HasField("result_tensor") else None)
                if len(results) == len(arrs):
                    break
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.UNIMPLEMENTED:
                raise
            return self._send_each(arrs, request_id, timeout)
        finally:
            stream.cancel()  # a no-op on a finished stream
        missing = [i for i in range(len(arrs)) if i not in results]
        if missing:
            raise RuntimeError(
                f"relay stream ended without results for items {missing}")
        return [results[i] for i in range(len(arrs))]

    def _send_each(self, arrs, request_id, timeout):
        """The unary fallback of send_tensors, one item after another."""
        return [self.send_tensor(a, request_id=request_id, timeout=timeout)
                for a in arrs]

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

    def generate_text(self, prompt: str, *, max_new_tokens: int = 32,
                      timeout: float = 120.0, **options) -> str:
        """Prompt text -> the generated text, from a daemon with a
        tokenizer: the prompt rides SendMessage's text, the options its
        sender_id (gen_request_id's grammar)."""
        return self.send_message(gen_request_id(max_new_tokens, **options),
                                 prompt, timeout=timeout)

    def generate_text_stream(self, prompt: str, tokenizer, *,
                             max_new_tokens: int = 32, timeout: float = 120.0,
                             **options):
        """Yield text chunks as tokens commit: the prompt encoded with
        `tokenizer` (the daemon's own) rides GenerateStream, and a
        character split across tokens is held until it is complete, so
        the chunks joined equal the one-shot decode of the stream."""
        from dnn_tpu_torch.io.tokenizer import stream_detokenizer

        det = stream_detokenizer(tokenizer)
        for tok in self.generate_stream(tokenizer.encode(prompt),
                                        max_new_tokens=max_new_tokens,
                                        timeout=timeout, **options):
            chunk = det.push(tok)
            if chunk:
                yield chunk
        tail = det.flush()
        if tail:
            yield tail

    def close(self):
        self._channel.close()
