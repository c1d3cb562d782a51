"""Exceptions the port raises where the JAX package raises its own
(:mod:`maggy_tpu.exceptions`); a copy of the classes the serving slice uses."""


class MaggyError(Exception):
    """Base class of the port's exceptions."""


class BadArgumentsError(MaggyError):
    """A function was called with inconsistent arguments."""

    def __init__(self, fn_name, detail=""):
        super().__init__(f"Bad arguments for {fn_name}. {detail}".strip())
