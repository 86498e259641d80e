"""Error hierarchy.

Behavioral contract: reference ``src/err.rs`` (``Error`` enum), for the
variants the ported slices raise; everything propagates to one exit
point in the CLI (``main.rs:147-156`` analog in ``cli.py``).  A subset
of ``noaa_apt_tpu/err.py``, so that both packages raise the same
messages.
"""


class AptError(Exception):
    """Base class for all decode-engine errors."""


class InternalError(AptError):
    """Reference ``Error::Internal`` — invariant violations and
    guard-rail failures (too-short recordings, bad buffer lengths)."""


class RateOverflowError(AptError):
    """Reference ``Error::RateOverflow`` — interpolated sample rate
    exceeded u32 (rates with tiny GCD, ``dsp.rs:82-91``)."""


class WavOpenError(AptError):
    """Reference ``Error::WavOpen`` — malformed WAV container."""


class DeserializeError(AptError):
    """Reference ``Error::Deserialize`` — bad settings file."""


class InvalidInputError(AptError):
    """Reference ``Error::InvalidInput`` — bad palette/user input."""


class FeatureNotAvailableError(AptError):
    """Reference ``Error::FeatureNotAvailable`` (e.g. a deep-space TLE)."""


class RequestError(AptError):
    """Reference ``Error::Request`` — network (TLE download) failures."""
