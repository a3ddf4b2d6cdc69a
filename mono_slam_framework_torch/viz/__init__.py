"""Host-side visualization (numpy)."""
