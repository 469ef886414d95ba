"""The paths a configuration's runs drive, one module each (a
configuration names its ``entry``); each has ``run(ctx) -> record``."""
