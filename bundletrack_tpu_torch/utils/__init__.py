"""Host-side helpers: parameter files."""
