"""Host-side operations of the port (the router)."""
