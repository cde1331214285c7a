"""Program sources and the qchip of the benchmark's deployments."""
