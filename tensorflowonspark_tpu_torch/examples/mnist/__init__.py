"""The MNIST examples of the port (InputMode.SPARK and TENSORFLOW, the
Spark-ML pipeline and TFParallel inference)."""
