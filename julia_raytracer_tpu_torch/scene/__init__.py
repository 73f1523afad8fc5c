"""Host-side scene model (numpy) and flattening."""
