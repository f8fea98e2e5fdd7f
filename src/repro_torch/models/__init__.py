"""The paper models of the port (batched over devices)."""
