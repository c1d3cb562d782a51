"""Exception hierarchy: the port's copy of :mod:`maggy_tpu.exceptions`.

Mirrors the reference's ``maggy/core/exceptions.py`` surface (core/exceptions.py:22-111)
and adds the RPC/scheduling errors the control plane needs.
"""


class MaggyError(Exception):
    """Base class for all framework errors."""


class EarlyStopException(MaggyError):
    """Raised inside ``reporter.broadcast`` when the driver asked this trial to stop
    (reference core/exceptions.py:22, reporter.py:100-101)."""

    def __init__(self, metric=None):
        super().__init__("Early stop requested by the experiment driver.")
        self.metric = metric


class NotSupportedError(MaggyError):
    """A config value is not supported (reference core/exceptions.py:30)."""

    def __init__(self, category, value, suggestion=""):
        super().__init__(
            f"{category} {value!r} is not supported. {suggestion}".strip()
        )


class ReturnTypeError(MaggyError):
    """train_fn returned something that is neither a number nor a dict with the
    optimization key (reference core/exceptions.py:42)."""

    def __init__(self, optimization_key, return_val):
        super().__init__(
            f"The train_fn return value must be numeric or a dict containing the "
            f"optimization key {optimization_key!r}; got {type(return_val).__name__}: "
            f"{return_val!r}"
        )


class MetricTypeError(MaggyError):
    """The optimization metric inside the returned dict has a bad type
    (reference core/exceptions.py:56)."""

    def __init__(self, optimization_key, metric):
        super().__init__(
            f"The metric {optimization_key!r} must be numeric, got "
            f"{type(metric).__name__}: {metric!r}"
        )


class BroadcastMetricTypeError(MaggyError):
    """reporter.broadcast called with a non-numeric metric (reference core/exceptions.py:69)."""

    def __init__(self, metric):
        super().__init__(
            f"Broadcast metrics must be numeric, got {type(metric).__name__}: {metric!r}"
        )


class BroadcastStepTypeError(MaggyError):
    """reporter.broadcast called with a non-integer step (reference core/exceptions.py:81)."""

    def __init__(self, metric, step):
        super().__init__(
            f"Broadcast step for metric {metric!r} must be an int, got "
            f"{type(step).__name__}: {step!r}"
        )


class BroadcastStepValueError(MaggyError):
    """reporter.broadcast called with a non-monotonic step (reference core/exceptions.py:95)."""

    def __init__(self, metric, step, last_step):
        super().__init__(
            f"Broadcast step must be monotonically increasing: got step {step} after "
            f"{last_step} (metric {metric!r})."
        )


class BadArgumentsError(MaggyError):
    """A function was called with inconsistent arguments (reference core/exceptions.py:111)."""

    def __init__(self, fn_name, detail=""):
        super().__init__(f"Bad arguments for {fn_name}. {detail}".strip())


class RpcError(MaggyError):
    """Control-plane transport failure (connect/auth/framing)."""


class RpcRejectedError(RpcError):
    """The server understood the frame and refused it (ERR reply: bad
    secret, unknown verb, handler-raised validation error). Never retried —
    resending the same message gets the same answer — unlike the transport
    failures its parent covers, which reconnect-and-retry."""


class ServerBusyError(RpcError):
    """429-style admission shed: the serving router projected TTFT past the
    configured SLO (or has no healthy replica) and declined the request
    instead of queueing it. Transient by nature — back off and resubmit
    (``ServeClient.submit(retry_busy=...)`` does it with the rpc jitter)."""


class WorkerLost(MaggyError):
    """The worker hosting in-flight work died out from under it (preemption,
    host loss, chaos kill). A TRANSIENT failure by definition: the runtime
    requeues/restarts the interrupted work instead of failing the experiment
    (resilience/policy.py classify_failure). Executors let this propagate —
    it is a worker death, never a trial error."""


class ReservationTimeoutError(MaggyError):
    """Not all executors registered within the reservation window
    (reference rpc.py:282-303 analogue)."""

    def __init__(self, registered, expected, timeout):
        super().__init__(
            f"Only {registered}/{expected} executors registered within {timeout:.0f}s."
        )


class ExperimentAbortedError(MaggyError):
    """The driver aborted the experiment (worker exception or user interrupt)."""
