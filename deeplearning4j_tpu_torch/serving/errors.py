"""Structured serving errors.

Every way the model server refuses or fails a request is a typed error
with a ``retriable`` flag, so clients (and load balancers in front of a
replica fleet) can distinguish "back off and retry elsewhere"
(overload, drain, breaker-open) from "this request is gone for good"
(deadline exceeded). The TensorFlow serving architecture (PAPERS.md)
makes the same split: load shedding must be *visible* — a request is
either answered or failed with a structured reason, never silently
dropped.

No torch / heavy imports here: the error taxonomy is part of the wire
contract and must be importable from thin clients. (A copy of the JAX
package's ``serving/errors.py``; the port does not import that package.)

Wire mapping (the documented error-code <-> exception taxonomy an HTTP
front door returns):

======================  ======  =========  =======================
exception               status  retriable  Retry-After
======================  ======  =========  =======================
ServerOverloadedError    429    yes        backoff hint (default)
ServerDrainingError      503    yes        backoff hint (default)
ServerUnhealthyError     503    yes        breaker cooldown
ServerClosedError        503    yes        backoff hint (default)
DeadlineExceededError    504    no         — (set a new deadline)
======================  ======  =========  =======================

Each class carries ``status_code`` so the mapping lives WITH the
taxonomy (thin clients and a front door read the same table); anything
else (dispatch failure after retries, unexpected errors) is a plain
500 without a retriable hint.
"""

from __future__ import annotations

from typing import Optional


class ServingError(RuntimeError):
    """Base class for every structured serving failure.

    ``retriable`` tells the caller whether retrying — against this
    replica after backoff, or against another replica — can succeed.
    ``status_code`` is the wire status the ingress maps this error to.
    """

    retriable = False
    status_code = 500


class ServerOverloadedError(ServingError):
    """Admission control rejected the request: the bounded queue is
    full. Retriable — back off or route to another replica; admitting
    it would only have grown latency for every queued request."""

    retriable = True
    status_code = 429

    def __init__(self, queue_depth: int, max_queue: int):
        self.queue_depth = int(queue_depth)
        self.max_queue = int(max_queue)
        super().__init__(
            f"server overloaded: request queue full "
            f"({self.queue_depth}/{self.max_queue}) — retry with backoff "
            "or against another replica")


class DeadlineExceededError(ServingError):
    """The request's deadline expired while it was queued; it was shed
    before dispatch (its batch slot was reclaimed). NOT retriable as-is:
    the deadline the client set has passed — a retry needs a new one."""

    retriable = False
    status_code = 504

    def __init__(self, waited: float, deadline: float):
        self.waited = float(waited)
        self.deadline = float(deadline)
        super().__init__(
            f"deadline exceeded: request waited {self.waited * 1e3:.1f} ms "
            f"against a {self.deadline * 1e3:.1f} ms deadline and was shed "
            "before dispatch")


class ServerDrainingError(ServingError):
    """The server is draining (SIGTERM / preemption / ``drain()``):
    admissions are stopped and queued-but-undispatched requests are
    failed. Retriable — another replica can serve it."""

    retriable = True
    status_code = 503

    def __init__(self, msg: str = "server draining: request not "
                 "dispatched — retry against another replica"):
        super().__init__(msg)


class ServerClosedError(ServingError):
    """The server is closed; nothing will be dispatched. Retriable
    against another replica."""

    retriable = True
    status_code = 503

    def __init__(self):
        super().__init__("model server is closed")


class ServerUnhealthyError(ServingError):
    """The circuit breaker is open after consecutive dispatch failures:
    the server fails fast instead of queueing requests it cannot serve.
    ``retry_after`` is the seconds until the half-open recovery probe."""

    retriable = True
    status_code = 503

    def __init__(self, failures: int, retry_after: Optional[float] = None):
        self.failures = int(failures)
        self.retry_after = retry_after
        after = (f"; retry after {retry_after:.2f}s"
                 if retry_after is not None else "")
        super().__init__(
            f"server unhealthy: circuit breaker open after "
            f"{self.failures} consecutive dispatch failures{after}")
