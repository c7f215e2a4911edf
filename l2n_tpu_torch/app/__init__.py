"""Application layer: headless CLI and PNG display sink."""
