"""Host-side utilities of the port: colour maps and training summaries."""
