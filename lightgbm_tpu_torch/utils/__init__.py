from .log import Log, LightGBMError, verbosity_to_level

__all__ = ["Log", "LightGBMError", "verbosity_to_level"]
