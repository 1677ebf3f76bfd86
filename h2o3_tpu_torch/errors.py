"""The port's error types (counterpart of h2o3_tpu/errors.py)."""


class CapabilityGate(NotImplementedError):
    """A deliberate gate on a missing optional decoder or SDK, as opposed
    to an unimplemented hook."""
