"""gRPC service plumbing for the NodeService wire (port of
dnn_tpu/comm/service.py:90-105,817-853).

Methods are registered with explicit (de)serializer callables — the
hand-coded codec for the Tensor messages, the generated protobuf classes
for the rest — so a peer running either package, or real protobuf,
interoperates byte for byte.
"""

from __future__ import annotations

import json

import grpc
import numpy as np

from dnn_tpu_torch.comm import wire_pb2 as pb
from dnn_tpu_torch.comm import wirecodec as wc

SERVICE_NAME = "node_service.NodeService"

GRPC_MSG_OPTIONS = [
    ("grpc.max_receive_message_length", 64 * 1024 * 1024),
    ("grpc.max_send_message_length", 64 * 1024 * 1024),
]

# The JAX client opens every connection with a transport-negotiation
# hello on SendMessage (dnn_tpu/comm/transport.py); the LM daemon
# declines it, and the client stays on plain gRPC.
HELLO_SENDER = "dnn_tpu.transport.hello"


def decline_hello(reason: str) -> str:
    return json.dumps({"v": 1, "ok": False, "reason": reason})


def _tensor_msg(arr) -> wc.Tensor:
    """array -> wire Tensor (payload as a view of the array's buffer)."""
    return wc.make_tensor(arr)


def _tensor_arr(msg) -> np.ndarray:
    """wire Tensor -> read-only ndarray view; raises
    wc.PayloadCorruptError on a declared-checksum mismatch."""
    return wc.tensor_view(msg)


def _handlers(servicer):
    """Generic handler for SendTensor, HealthCheck, SendMessage and —
    when the servicer has it — the streaming GenerateStream."""
    handlers = {
        "SendTensor": grpc.unary_unary_rpc_method_handler(
            servicer.SendTensor,
            request_deserializer=wc.parse_request,
            response_serializer=wc.serialize_response,
        ),
        "HealthCheck": grpc.unary_unary_rpc_method_handler(
            servicer.HealthCheck,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.HealthCheckResponse.SerializeToString,
        ),
        "SendMessage": grpc.unary_unary_rpc_method_handler(
            servicer.SendMessage,
            request_deserializer=pb.MessageRequest.FromString,
            response_serializer=pb.MessageReply.SerializeToString,
        ),
    }
    if hasattr(servicer, "GenerateStream"):
        handlers["GenerateStream"] = grpc.unary_stream_rpc_method_handler(
            servicer.GenerateStream,
            request_deserializer=wc.parse_request,
            response_serializer=wc.serialize_response,
        )
    return grpc.method_handlers_generic_handler(SERVICE_NAME, handlers)
