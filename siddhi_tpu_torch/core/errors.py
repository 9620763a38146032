"""Framework exceptions (analog of reference core/exception/*)."""


class SiddhiAppCreationError(Exception):
    """App failed to parse/validate/compile (reference: SiddhiAppCreationException)."""


class SiddhiParserError(SiddhiAppCreationError):
    """SiddhiQL syntax error, with line/column context."""

    def __init__(self, message: str, line: int | None = None, col: int | None = None):
        loc = f" at line {line}:{col}" if line is not None else ""
        super().__init__(f"{message}{loc}")
        self.line, self.col = line, col


class SiddhiAppRuntimeError(Exception):
    """Runtime processing failure (reference: SiddhiAppRuntimeException)."""


class DefinitionNotExistError(SiddhiAppCreationError):
    pass


class StoreQueryCreationError(SiddhiAppCreationError):
    pass


class ConnectionUnavailableError(Exception):
    """Transport connection loss; triggers source/sink retry
    (reference: exception/ConnectionUnavailableException.java)."""
