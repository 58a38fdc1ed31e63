"""Request early stop of a live cluster from outside the driver — the port
of ``examples/utils/stop_cluster.py``: ``reservation.Client.request_stop``
against the cluster's reservation server, whose address the driver prints
at startup; the driver then sees ``cluster.stop_requested``.

Usage::

    python -m tensorflowonspark_tpu_torch.examples.utils.stop_cluster <host> <port>
"""

import sys

from tensorflowonspark_tpu_torch import reservation


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        raise SystemExit(2)
    host, port = argv[0], int(argv[1])
    client = reservation.Client((host, port))
    client.request_stop()
    print("requested stop of cluster at {}:{}".format(host, port))


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    main()
