"""Command-line entry points (``tnn_tpu.cli``). Each module has
``main(argv=None)`` and ``cli = console_entry(main)``, the function a
``tnn-torch-*`` console script in pyproject.toml calls."""


def console_entry(main):
    """Wrap a module's ``main(argv=None)`` for a console script. The
    generated wrapper does ``sys.exit(cli())``, so a return value that is
    not an exit code (library callers use those: a state, a dict) is
    discarded; an int (``cli.serve``'s code) is passed on."""
    def cli():
        rc = main()
        return rc if type(rc) is int else None
    return cli
