"""Host-side utilities: the build-cache switch, plots and the flight report."""
