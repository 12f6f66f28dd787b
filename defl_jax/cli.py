"""Console entry points (pyproject [project.scripts])."""


def bench_main():
    from defl_jax.bench import main

    main()
