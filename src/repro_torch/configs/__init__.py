"""Model configurations (``repro.configs``): the schema and the archs the port builds."""
