"""Host-side image helpers of the port."""
