"""The port's copy of the model-routing gateway's text path (``smg_tpu/gateway``):
HTTP routes, worker registry and breakers, health monitoring, KV-event
routing feed, the token-level router and the ``serve`` process assembly."""
