"""gRPC worker protocol: proto messages + hand-wired aio stubs.

Reference: ``crates/grpc_client`` (client side) and
``grpc_servicer/smg_grpc_servicer`` (server side), SURVEY.md §2.2-2.3.
"""

SERVICE = "smg_tpu.Scheduler"


def method(name: str) -> str:
    return f"/{SERVICE}/{name}"
