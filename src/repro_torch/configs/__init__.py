"""Published model configurations and the shape sets they pair with."""
