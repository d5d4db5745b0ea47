from .wee25 import MsgMatrixStream, Wee25Commit, Wee25PublicParams  # noqa: F401
