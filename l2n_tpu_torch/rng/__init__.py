"""The samplers of every `RenderConfig.rng` mode: counter-based threefry and
Philox (`tpu_hw`), and the stateful TinyMT and TausLCG parity modes."""
