"""Model stack of the port (moonshot layout: GQA attention, dense and MoE FFNs)."""
