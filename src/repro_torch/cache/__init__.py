"""Host-side page pool and radix prefix cache (numpy only)."""
