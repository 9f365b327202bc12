"""The port's share of the JAX package's fleet plane (dnn_tpu/control):
`handoff.py`, the wire format of the prefill->decode KV handoff. The
router, the replica set and the policies wait for ROADMAP Queue 1 item
11."""
