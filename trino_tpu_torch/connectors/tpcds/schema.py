"""TPC-DS schema: 24 tables, column definitions, scaled row counts.

Reference role: the table/column metadata plugin/trino-tpcds exposes
(TpcdsMetadata.java); definitions follow the public TPC-DS specification
(v2.x).  `identifier` columns are bigint surrogate keys; money is
decimal(7,2); business ids are fixed-width strings.
"""

from __future__ import annotations

import math

from trino_tpu_torch import types as T

# compact type aliases used in the declarations below
_SK = "bigint"          # surrogate key
_ID = "varchar(16)"     # business id
_MONEY = "decimal(7,2)"
_QTY = "integer"
_DATE = "date"
_FLAG = "varchar(1)"


TABLES: dict[str, list[tuple[str, str]]] = {
    "store_sales": [
        ("ss_sold_date_sk", _SK), ("ss_sold_time_sk", _SK), ("ss_item_sk", _SK),
        ("ss_customer_sk", _SK), ("ss_cdemo_sk", _SK), ("ss_hdemo_sk", _SK),
        ("ss_addr_sk", _SK), ("ss_store_sk", _SK), ("ss_promo_sk", _SK),
        ("ss_ticket_number", "bigint"), ("ss_quantity", _QTY),
        ("ss_wholesale_cost", _MONEY), ("ss_list_price", _MONEY),
        ("ss_sales_price", _MONEY), ("ss_ext_discount_amt", _MONEY),
        ("ss_ext_sales_price", _MONEY), ("ss_ext_wholesale_cost", _MONEY),
        ("ss_ext_list_price", _MONEY), ("ss_ext_tax", _MONEY),
        ("ss_coupon_amt", _MONEY), ("ss_net_paid", _MONEY),
        ("ss_net_paid_inc_tax", _MONEY), ("ss_net_profit", _MONEY),
    ],
    "store_returns": [
        ("sr_returned_date_sk", _SK), ("sr_return_time_sk", _SK),
        ("sr_item_sk", _SK), ("sr_customer_sk", _SK), ("sr_cdemo_sk", _SK),
        ("sr_hdemo_sk", _SK), ("sr_addr_sk", _SK), ("sr_store_sk", _SK),
        ("sr_reason_sk", _SK), ("sr_ticket_number", "bigint"),
        ("sr_return_quantity", _QTY), ("sr_return_amt", _MONEY),
        ("sr_return_tax", _MONEY), ("sr_return_amt_inc_tax", _MONEY),
        ("sr_fee", _MONEY), ("sr_return_ship_cost", _MONEY),
        ("sr_refunded_cash", _MONEY), ("sr_reversed_charge", _MONEY),
        ("sr_store_credit", _MONEY), ("sr_net_loss", _MONEY),
    ],
    "catalog_sales": [
        ("cs_sold_date_sk", _SK), ("cs_sold_time_sk", _SK),
        ("cs_ship_date_sk", _SK), ("cs_bill_customer_sk", _SK),
        ("cs_bill_cdemo_sk", _SK), ("cs_bill_hdemo_sk", _SK),
        ("cs_bill_addr_sk", _SK), ("cs_ship_customer_sk", _SK),
        ("cs_ship_cdemo_sk", _SK), ("cs_ship_hdemo_sk", _SK),
        ("cs_ship_addr_sk", _SK), ("cs_call_center_sk", _SK),
        ("cs_catalog_page_sk", _SK), ("cs_ship_mode_sk", _SK),
        ("cs_warehouse_sk", _SK), ("cs_item_sk", _SK), ("cs_promo_sk", _SK),
        ("cs_order_number", "bigint"), ("cs_quantity", _QTY),
        ("cs_wholesale_cost", _MONEY), ("cs_list_price", _MONEY),
        ("cs_sales_price", _MONEY), ("cs_ext_discount_amt", _MONEY),
        ("cs_ext_sales_price", _MONEY), ("cs_ext_wholesale_cost", _MONEY),
        ("cs_ext_list_price", _MONEY), ("cs_ext_tax", _MONEY),
        ("cs_coupon_amt", _MONEY), ("cs_ext_ship_cost", _MONEY),
        ("cs_net_paid", _MONEY), ("cs_net_paid_inc_tax", _MONEY),
        ("cs_net_paid_inc_ship", _MONEY), ("cs_net_paid_inc_ship_tax", _MONEY),
        ("cs_net_profit", _MONEY),
    ],
    "catalog_returns": [
        ("cr_returned_date_sk", _SK), ("cr_returned_time_sk", _SK),
        ("cr_item_sk", _SK), ("cr_refunded_customer_sk", _SK),
        ("cr_refunded_cdemo_sk", _SK), ("cr_refunded_hdemo_sk", _SK),
        ("cr_refunded_addr_sk", _SK), ("cr_returning_customer_sk", _SK),
        ("cr_returning_cdemo_sk", _SK), ("cr_returning_hdemo_sk", _SK),
        ("cr_returning_addr_sk", _SK), ("cr_call_center_sk", _SK),
        ("cr_catalog_page_sk", _SK), ("cr_ship_mode_sk", _SK),
        ("cr_warehouse_sk", _SK), ("cr_reason_sk", _SK),
        ("cr_order_number", "bigint"), ("cr_return_quantity", _QTY),
        ("cr_return_amount", _MONEY), ("cr_return_tax", _MONEY),
        ("cr_return_amt_inc_tax", _MONEY), ("cr_fee", _MONEY),
        ("cr_return_ship_cost", _MONEY), ("cr_refunded_cash", _MONEY),
        ("cr_reversed_charge", _MONEY), ("cr_store_credit", _MONEY),
        ("cr_net_loss", _MONEY),
    ],
    "web_sales": [
        ("ws_sold_date_sk", _SK), ("ws_sold_time_sk", _SK),
        ("ws_ship_date_sk", _SK), ("ws_item_sk", _SK),
        ("ws_bill_customer_sk", _SK), ("ws_bill_cdemo_sk", _SK),
        ("ws_bill_hdemo_sk", _SK), ("ws_bill_addr_sk", _SK),
        ("ws_ship_customer_sk", _SK), ("ws_ship_cdemo_sk", _SK),
        ("ws_ship_hdemo_sk", _SK), ("ws_ship_addr_sk", _SK),
        ("ws_web_page_sk", _SK), ("ws_web_site_sk", _SK),
        ("ws_ship_mode_sk", _SK), ("ws_warehouse_sk", _SK),
        ("ws_promo_sk", _SK), ("ws_order_number", "bigint"),
        ("ws_quantity", _QTY), ("ws_wholesale_cost", _MONEY),
        ("ws_list_price", _MONEY), ("ws_sales_price", _MONEY),
        ("ws_ext_discount_amt", _MONEY), ("ws_ext_sales_price", _MONEY),
        ("ws_ext_wholesale_cost", _MONEY), ("ws_ext_list_price", _MONEY),
        ("ws_ext_tax", _MONEY), ("ws_coupon_amt", _MONEY),
        ("ws_ext_ship_cost", _MONEY), ("ws_net_paid", _MONEY),
        ("ws_net_paid_inc_tax", _MONEY), ("ws_net_paid_inc_ship", _MONEY),
        ("ws_net_paid_inc_ship_tax", _MONEY), ("ws_net_profit", _MONEY),
    ],
    "web_returns": [
        ("wr_returned_date_sk", _SK), ("wr_returned_time_sk", _SK),
        ("wr_item_sk", _SK), ("wr_refunded_customer_sk", _SK),
        ("wr_refunded_cdemo_sk", _SK), ("wr_refunded_hdemo_sk", _SK),
        ("wr_refunded_addr_sk", _SK), ("wr_returning_customer_sk", _SK),
        ("wr_returning_cdemo_sk", _SK), ("wr_returning_hdemo_sk", _SK),
        ("wr_returning_addr_sk", _SK), ("wr_web_page_sk", _SK),
        ("wr_reason_sk", _SK), ("wr_order_number", "bigint"),
        ("wr_return_quantity", _QTY), ("wr_return_amt", _MONEY),
        ("wr_return_tax", _MONEY), ("wr_return_amt_inc_tax", _MONEY),
        ("wr_fee", _MONEY), ("wr_return_ship_cost", _MONEY),
        ("wr_refunded_cash", _MONEY), ("wr_reversed_charge", _MONEY),
        ("wr_account_credit", _MONEY), ("wr_net_loss", _MONEY),
    ],
    "inventory": [
        ("inv_date_sk", _SK), ("inv_item_sk", _SK), ("inv_warehouse_sk", _SK),
        ("inv_quantity_on_hand", _QTY),
    ],
    "date_dim": [
        ("d_date_sk", _SK), ("d_date_id", _ID), ("d_date", _DATE),
        ("d_month_seq", "integer"), ("d_week_seq", "integer"),
        ("d_quarter_seq", "integer"), ("d_year", "integer"), ("d_dow", "integer"),
        ("d_moy", "integer"), ("d_dom", "integer"), ("d_qoy", "integer"),
        ("d_fy_year", "integer"), ("d_fy_quarter_seq", "integer"),
        ("d_fy_week_seq", "integer"), ("d_day_name", "varchar(9)"),
        ("d_quarter_name", "varchar(6)"), ("d_holiday", _FLAG),
        ("d_weekend", _FLAG), ("d_following_holiday", _FLAG),
        ("d_first_dom", "integer"), ("d_last_dom", "integer"),
        ("d_same_day_ly", "integer"), ("d_same_day_lq", "integer"),
        ("d_current_day", _FLAG), ("d_current_week", _FLAG),
        ("d_current_month", _FLAG), ("d_current_quarter", _FLAG),
        ("d_current_year", _FLAG),
    ],
    "time_dim": [
        ("t_time_sk", _SK), ("t_time_id", _ID), ("t_time", "integer"),
        ("t_hour", "integer"), ("t_minute", "integer"), ("t_second", "integer"),
        ("t_am_pm", "varchar(2)"), ("t_shift", "varchar(20)"),
        ("t_sub_shift", "varchar(20)"), ("t_meal_time", "varchar(20)"),
    ],
    "item": [
        ("i_item_sk", _SK), ("i_item_id", _ID), ("i_rec_start_date", _DATE),
        ("i_rec_end_date", _DATE), ("i_item_desc", "varchar(200)"),
        ("i_current_price", _MONEY), ("i_wholesale_cost", _MONEY),
        ("i_brand_id", "integer"), ("i_brand", "varchar(50)"),
        ("i_class_id", "integer"), ("i_class", "varchar(50)"),
        ("i_category_id", "integer"), ("i_category", "varchar(50)"),
        ("i_manufact_id", "integer"), ("i_manufact", "varchar(50)"),
        ("i_size", "varchar(20)"), ("i_formulation", "varchar(20)"),
        ("i_color", "varchar(20)"), ("i_units", "varchar(10)"),
        ("i_container", "varchar(10)"), ("i_manager_id", "integer"),
        ("i_product_name", "varchar(50)"),
    ],
    "customer": [
        ("c_customer_sk", _SK), ("c_customer_id", _ID),
        ("c_current_cdemo_sk", _SK), ("c_current_hdemo_sk", _SK),
        ("c_current_addr_sk", _SK), ("c_first_shipto_date_sk", _SK),
        ("c_first_sales_date_sk", _SK), ("c_salutation", "varchar(10)"),
        ("c_first_name", "varchar(20)"), ("c_last_name", "varchar(30)"),
        ("c_preferred_cust_flag", _FLAG), ("c_birth_day", "integer"),
        ("c_birth_month", "integer"), ("c_birth_year", "integer"),
        ("c_birth_country", "varchar(20)"), ("c_login", "varchar(13)"),
        ("c_email_address", "varchar(50)"), ("c_last_review_date_sk", _SK),
    ],
    "customer_address": [
        ("ca_address_sk", _SK), ("ca_address_id", _ID),
        ("ca_street_number", "varchar(10)"), ("ca_street_name", "varchar(60)"),
        ("ca_street_type", "varchar(15)"), ("ca_suite_number", "varchar(10)"),
        ("ca_city", "varchar(60)"), ("ca_county", "varchar(30)"),
        ("ca_state", "varchar(2)"), ("ca_zip", "varchar(10)"),
        ("ca_country", "varchar(20)"), ("ca_gmt_offset", "decimal(5,2)"),
        ("ca_location_type", "varchar(20)"),
    ],
    "customer_demographics": [
        ("cd_demo_sk", _SK), ("cd_gender", _FLAG),
        ("cd_marital_status", _FLAG), ("cd_education_status", "varchar(20)"),
        ("cd_purchase_estimate", "integer"), ("cd_credit_rating", "varchar(10)"),
        ("cd_dep_count", "integer"), ("cd_dep_employed_count", "integer"),
        ("cd_dep_college_count", "integer"),
    ],
    "household_demographics": [
        ("hd_demo_sk", _SK), ("hd_income_band_sk", _SK),
        ("hd_buy_potential", "varchar(15)"), ("hd_dep_count", "integer"),
        ("hd_vehicle_count", "integer"),
    ],
    "income_band": [
        ("ib_income_band_sk", _SK), ("ib_lower_bound", "integer"),
        ("ib_upper_bound", "integer"),
    ],
    "promotion": [
        ("p_promo_sk", _SK), ("p_promo_id", _ID), ("p_start_date_sk", _SK),
        ("p_end_date_sk", _SK), ("p_item_sk", _SK), ("p_cost", "decimal(15,2)"),
        ("p_response_target", "integer"), ("p_promo_name", "varchar(50)"),
        ("p_channel_dmail", _FLAG), ("p_channel_email", _FLAG),
        ("p_channel_catalog", _FLAG), ("p_channel_tv", _FLAG),
        ("p_channel_radio", _FLAG), ("p_channel_press", _FLAG),
        ("p_channel_event", _FLAG), ("p_channel_demo", _FLAG),
        ("p_channel_details", "varchar(100)"), ("p_purpose", "varchar(15)"),
        ("p_discount_active", _FLAG),
    ],
    "reason": [
        ("r_reason_sk", _SK), ("r_reason_id", _ID),
        ("r_reason_desc", "varchar(100)"),
    ],
    "ship_mode": [
        ("sm_ship_mode_sk", _SK), ("sm_ship_mode_id", _ID),
        ("sm_type", "varchar(30)"), ("sm_code", "varchar(10)"),
        ("sm_carrier", "varchar(20)"), ("sm_contract", "varchar(20)"),
    ],
    "store": [
        ("s_store_sk", _SK), ("s_store_id", _ID), ("s_rec_start_date", _DATE),
        ("s_rec_end_date", _DATE), ("s_closed_date_sk", _SK),
        ("s_store_name", "varchar(50)"), ("s_number_employees", "integer"),
        ("s_floor_space", "integer"), ("s_hours", "varchar(20)"),
        ("s_manager", "varchar(40)"), ("s_market_id", "integer"),
        ("s_geography_class", "varchar(100)"), ("s_market_desc", "varchar(100)"),
        ("s_market_manager", "varchar(40)"), ("s_division_id", "integer"),
        ("s_division_name", "varchar(50)"), ("s_company_id", "integer"),
        ("s_company_name", "varchar(50)"), ("s_street_number", "varchar(10)"),
        ("s_street_name", "varchar(60)"), ("s_street_type", "varchar(15)"),
        ("s_suite_number", "varchar(10)"), ("s_city", "varchar(60)"),
        ("s_county", "varchar(30)"), ("s_state", "varchar(2)"),
        ("s_zip", "varchar(10)"), ("s_country", "varchar(20)"),
        ("s_gmt_offset", "decimal(5,2)"), ("s_tax_precentage", "decimal(5,2)"),
    ],
    "call_center": [
        ("cc_call_center_sk", _SK), ("cc_call_center_id", _ID),
        ("cc_rec_start_date", _DATE), ("cc_rec_end_date", _DATE),
        ("cc_closed_date_sk", _SK), ("cc_open_date_sk", _SK),
        ("cc_name", "varchar(50)"), ("cc_class", "varchar(50)"),
        ("cc_employees", "integer"), ("cc_sq_ft", "integer"),
        ("cc_hours", "varchar(20)"), ("cc_manager", "varchar(40)"),
        ("cc_mkt_id", "integer"), ("cc_mkt_class", "varchar(50)"),
        ("cc_mkt_desc", "varchar(100)"), ("cc_market_manager", "varchar(40)"),
        ("cc_division", "integer"), ("cc_division_name", "varchar(50)"),
        ("cc_company", "integer"), ("cc_company_name", "varchar(50)"),
        ("cc_street_number", "varchar(10)"), ("cc_street_name", "varchar(60)"),
        ("cc_street_type", "varchar(15)"), ("cc_suite_number", "varchar(10)"),
        ("cc_city", "varchar(60)"), ("cc_county", "varchar(30)"),
        ("cc_state", "varchar(2)"), ("cc_zip", "varchar(10)"),
        ("cc_country", "varchar(20)"), ("cc_gmt_offset", "decimal(5,2)"),
        ("cc_tax_percentage", "decimal(5,2)"),
    ],
    "catalog_page": [
        ("cp_catalog_page_sk", _SK), ("cp_catalog_page_id", _ID),
        ("cp_start_date_sk", _SK), ("cp_end_date_sk", _SK),
        ("cp_department", "varchar(50)"), ("cp_catalog_number", "integer"),
        ("cp_catalog_page_number", "integer"), ("cp_description", "varchar(100)"),
        ("cp_type", "varchar(100)"),
    ],
    "warehouse": [
        ("w_warehouse_sk", _SK), ("w_warehouse_id", _ID),
        ("w_warehouse_name", "varchar(20)"), ("w_warehouse_sq_ft", "integer"),
        ("w_street_number", "varchar(10)"), ("w_street_name", "varchar(60)"),
        ("w_street_type", "varchar(15)"), ("w_suite_number", "varchar(10)"),
        ("w_city", "varchar(60)"), ("w_county", "varchar(30)"),
        ("w_state", "varchar(2)"), ("w_zip", "varchar(10)"),
        ("w_country", "varchar(20)"), ("w_gmt_offset", "decimal(5,2)"),
    ],
    "web_page": [
        ("wp_web_page_sk", _SK), ("wp_web_page_id", _ID),
        ("wp_rec_start_date", _DATE), ("wp_rec_end_date", _DATE),
        ("wp_creation_date_sk", _SK), ("wp_access_date_sk", _SK),
        ("wp_autogen_flag", _FLAG), ("wp_customer_sk", _SK),
        ("wp_url", "varchar(100)"), ("wp_type", "varchar(50)"),
        ("wp_char_count", "integer"), ("wp_link_count", "integer"),
        ("wp_image_count", "integer"), ("wp_max_ad_count", "integer"),
    ],
    "web_site": [
        ("web_site_sk", _SK), ("web_site_id", _ID),
        ("web_rec_start_date", _DATE), ("web_rec_end_date", _DATE),
        ("web_name", "varchar(50)"), ("web_open_date_sk", _SK),
        ("web_close_date_sk", _SK), ("web_class", "varchar(50)"),
        ("web_manager", "varchar(40)"), ("web_mkt_id", "integer"),
        ("web_mkt_class", "varchar(50)"), ("web_mkt_desc", "varchar(100)"),
        ("web_market_manager", "varchar(40)"), ("web_company_id", "integer"),
        ("web_company_name", "varchar(50)"), ("web_street_number", "varchar(10)"),
        ("web_street_name", "varchar(60)"), ("web_street_type", "varchar(15)"),
        ("web_suite_number", "varchar(10)"), ("web_city", "varchar(60)"),
        ("web_county", "varchar(30)"), ("web_state", "varchar(2)"),
        ("web_zip", "varchar(10)"), ("web_country", "varchar(20)"),
        ("web_gmt_offset", "decimal(5,2)"), ("web_tax_percentage", "decimal(5,2)"),
    ],
}

#: SF1 row counts from the spec; facts scale linearly, starred dimensions are
#: fixed regardless of SF (the spec scales them in coarse steps; fixed is the
#: SF1 value)
SF1_ROWS = {
    "store_sales": 2_880_404,
    "store_returns": 287_514,
    "catalog_sales": 1_441_548,
    "catalog_returns": 144_067,
    "web_sales": 719_384,
    "web_returns": 71_763,
    "inventory": 11_745_000,
    "customer": 100_000,
    "customer_address": 50_000,
    "item": 18_000,
    "catalog_page": 11_718,
    "web_page": 60,
    "web_site": 30,
    "store": 12,
    "call_center": 6,
    "warehouse": 5,
    "promotion": 300,
    "reason": 35,
    "ship_mode": 20,
    "income_band": 20,
    "household_demographics": 7_200,
    "customer_demographics": 1_920_800,
    "date_dim": 73_049,
    "time_dim": 86_400,
}

_FIXED = {
    "date_dim", "time_dim", "income_band", "household_demographics",
    "customer_demographics", "ship_mode", "reason",
}
_SLOW = {  # dimensions that grow sub-linearly with SF (sqrt here)
    "customer", "customer_address", "item", "catalog_page", "web_page",
    "web_site", "store", "call_center", "warehouse", "promotion",
}


def scaled_rows(table: str, sf: float) -> int:
    base = SF1_ROWS[table]
    if table in _FIXED:
        return base
    if table in _SLOW:
        return max(2, int(base * math.sqrt(min(sf, 1.0)) if sf < 1 else base * math.sqrt(sf)))
    return max(1, int(base * sf))


SCHEMAS = {"tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0}


def schema_scale(schema: str) -> float:
    if schema in SCHEMAS:
        return SCHEMAS[schema]
    if schema.startswith("sf"):
        try:
            return float(schema[2:].replace("_", "."))
        except ValueError:
            pass
    raise KeyError(f"unknown tpcds schema: {schema}")


def column_types(table: str):
    return [(name, T.parse_type(t)) for name, t in TABLES[table]]
