"""The LM substrate of the port: layers, the MoE FFN with the Skipper
b-matching router, and the decoder-only transformer (``dense`` and ``moe``
families)."""
