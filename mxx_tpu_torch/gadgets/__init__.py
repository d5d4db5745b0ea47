from .secret_ip import secret_inner_product  # noqa: F401
