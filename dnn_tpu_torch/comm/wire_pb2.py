# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: wire.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nwire.proto\x12\x0cnode_service\"9\n\x0eMessageRequest\x12\x11\n\tsender_id\x18\x01 \x01(\t\x12\x14\n\x0cmessage_text\x18\x02 \x01(\t\")\n\x0cMessageReply\x12\x19\n\x11\x63onfirmation_text\x18\x01 \x01(\t\"\x07\n\x05\x45mpty\")\n\x13HealthCheckResponse\x12\x12\n\nis_healthy\x18\x01 \x01(\x08\"[\n\x06Tensor\x12\x13\n\x0btensor_data\x18\x01 \x01(\x0c\x12\r\n\x05shape\x18\x02 \x03(\x05\x12\r\n\x05\x64type\x18\x03 \x01(\t\x12\x13\n\x06\x63rc32c\x18\x04 \x01(\rH\x00\x88\x01\x01\x42\t\n\x07_crc32c\"I\n\rTensorRequest\x12\x12\n\nrequest_id\x18\x01 \x01(\t\x12$\n\x06tensor\x18\x02 \x01(\x0b\x32\x14.node_service.Tensor\"d\n\x0eTensorResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x30\n\rresult_tensor\x18\x02 \x01(\x0b\x32\x14.node_service.TensorH\x00\x88\x01\x01\x42\x10\n\x0e_result_tensor2\xb5\x02\n\x0bNodeService\x12G\n\x0bSendMessage\x12\x1c.node_service.MessageRequest\x1a\x1a.node_service.MessageReply\x12\x45\n\x0bHealthCheck\x12\x13.node_service.Empty\x1a!.node_service.HealthCheckResponse\x12G\n\nSendTensor\x12\x1b.node_service.TensorRequest\x1a\x1c.node_service.TensorResponse\x12M\n\x0eGenerateStream\x12\x1b.node_service.TensorRequest\x1a\x1c.node_service.TensorResponse0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'wire_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MESSAGEREQUEST._serialized_start=28
  _MESSAGEREQUEST._serialized_end=85
  _MESSAGEREPLY._serialized_start=87
  _MESSAGEREPLY._serialized_end=128
  _EMPTY._serialized_start=130
  _EMPTY._serialized_end=137
  _HEALTHCHECKRESPONSE._serialized_start=139
  _HEALTHCHECKRESPONSE._serialized_end=180
  _TENSOR._serialized_start=182
  _TENSOR._serialized_end=273
  _TENSORREQUEST._serialized_start=275
  _TENSORREQUEST._serialized_end=348
  _TENSORRESPONSE._serialized_start=350
  _TENSORRESPONSE._serialized_end=450
  _NODESERVICE._serialized_start=453
  _NODESERVICE._serialized_end=762
# @@protoc_insertion_point(module_scope)
