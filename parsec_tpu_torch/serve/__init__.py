"""Multi-tenant persistent serving over one shared Context.

Admission control, weighted-fair scheduling, per-tenant quotas and SLO
attribution in front of the untouched runtime.  Nothing here is
constructed unless a :class:`SessionServer` is — with the ``serve``
knob unset the runtime, schedulers and wire format are bit-for-bit
those of a build without it.
"""
from .client import ServeClient, ServeTimeout
from .fairness import TenantFairness
from .server import AdmissionError, SessionServer, Submission, Tenant

__all__ = ["AdmissionError", "ServeClient", "ServeTimeout",
           "SessionServer", "Submission", "Tenant", "TenantFairness"]
