"""TPC-DS benchmark queries (reference: the public spec query templates as
shipped under testing/trino-benchmark-queries/.../tpcds/*.sql).

Adaptations for this engine's dialect (noted per reference behavior, not
semantics): aggregate ORDER BY keys are aliased, `${database}.${schema}.`
prefixes dropped.  Q64 is baseline config #4 (BASELINE.md).
"""

QUERIES = {
    1: """
with customer_total_return as (
    select sr_customer_sk as ctr_customer_sk,
           sr_store_sk as ctr_store_sk,
           sum(sr_return_amt) as ctr_total_return
    from store_returns, date_dim
    where sr_returned_date_sk = d_date_sk and d_year = 2000
    group by sr_customer_sk, sr_store_sk
)
select c_customer_id
from customer_total_return ctr1, store, customer
where ctr1.ctr_total_return > (
        select avg(ctr_total_return) * 1.2
        from customer_total_return ctr2
        where ctr1.ctr_store_sk = ctr2.ctr_store_sk)
  and s_store_sk = ctr1.ctr_store_sk
  and s_state = 'TN'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id
limit 100
""",
    3: """
select dt.d_year, item.i_brand_id as brand_id, item.i_brand as brand,
       sum(ss_ext_sales_price) as sum_agg
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manufact_id = 128
  and dt.d_moy = 11
group by dt.d_year, item.i_brand_id, item.i_brand
order by dt.d_year, sum_agg desc, brand_id
limit 100
""",
    7: """
select i_item_id,
       avg(ss_quantity) as agg1,
       avg(ss_list_price) as agg2,
       avg(ss_coupon_amt) as agg3,
       avg(ss_sales_price) as agg4
from store_sales, customer_demographics, date_dim, item, promotion
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_cdemo_sk = cd_demo_sk
  and ss_promo_sk = p_promo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""",
    42: """
select dt.d_year, item.i_category_id, item.i_category,
       sum(ss_ext_sales_price) as total_sales
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manager_id = 1
  and dt.d_moy = 11
  and dt.d_year = 2000
group by dt.d_year, item.i_category_id, item.i_category
order by total_sales desc, dt.d_year, item.i_category_id, item.i_category
limit 100
""",
    52: """
select dt.d_year, item.i_brand_id as brand_id, item.i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manager_id = 1
  and dt.d_moy = 11
  and dt.d_year = 2000
group by dt.d_year, item.i_brand_id, item.i_brand
order by dt.d_year, ext_price desc, brand_id
limit 100
""",
    55: """
select i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 28
  and d_moy = 11
  and d_year = 1999
group by i_brand_id, i_brand
order by ext_price desc, brand_id
limit 100
""",
    68: """
select c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number,
       extended_price, extended_tax, list_price
from (
    select ss_ticket_number, ss_customer_sk, ca_city as bought_city,
           sum(ss_ext_sales_price) as extended_price,
           sum(ss_ext_list_price) as list_price,
           sum(ss_ext_tax) as extended_tax
    from store_sales, date_dim, store, household_demographics, customer_address
    where store_sales.ss_sold_date_sk = date_dim.d_date_sk
      and store_sales.ss_store_sk = store.s_store_sk
      and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
      and store_sales.ss_addr_sk = customer_address.ca_address_sk
      and date_dim.d_dom between 1 and 2
      and (household_demographics.hd_dep_count = 4
           or household_demographics.hd_vehicle_count = 3)
      and date_dim.d_year in (1999, 2000, 2001)
      and store.s_city in ('Fairview', 'Midway')
    group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city
) dn, customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and customer.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, ss_ticket_number
limit 100
""",
    96: """
select count(*) as cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = time_dim.t_time_sk
  and ss_hdemo_sk = household_demographics.hd_demo_sk
  and ss_store_sk = s_store_sk
  and time_dim.t_hour = 20
  and time_dim.t_minute >= 30
  and household_demographics.hd_dep_count = 7
  and store.s_store_name = 'ese'
""",
    64: """
with cs_ui as (
    select cs_item_sk,
           sum(cs_ext_list_price) as sale,
           sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit) as refund
    from catalog_sales, catalog_returns
    where cs_item_sk = cr_item_sk
      and cs_order_number = cr_order_number
    group by cs_item_sk
    having sum(cs_ext_list_price) >
           2 * sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)
),
cross_sales as (
    select i_product_name as product_name, i_item_sk as item_sk,
           s_store_name as store_name, s_zip as store_zip,
           ad1.ca_street_number as b_street_number,
           ad1.ca_street_name as b_street_name,
           ad1.ca_city as b_city, ad1.ca_zip as b_zip,
           ad2.ca_street_number as c_street_number,
           ad2.ca_street_name as c_street_name,
           ad2.ca_city as c_city, ad2.ca_zip as c_zip,
           d1.d_year as syear, d2.d_year as fsyear, d3.d_year as s2year,
           count(*) as cnt,
           sum(ss_wholesale_cost) as s1,
           sum(ss_list_price) as s2,
           sum(ss_coupon_amt) as s3
    from store_sales, store_returns, cs_ui,
         date_dim d1, date_dim d2, date_dim d3,
         store, customer, customer_demographics cd1, customer_demographics cd2,
         promotion, household_demographics hd1, household_demographics hd2,
         customer_address ad1, customer_address ad2,
         income_band ib1, income_band ib2, item
    where ss_store_sk = s_store_sk
      and ss_sold_date_sk = d1.d_date_sk
      and ss_customer_sk = c_customer_sk
      and ss_cdemo_sk = cd1.cd_demo_sk
      and ss_hdemo_sk = hd1.hd_demo_sk
      and ss_addr_sk = ad1.ca_address_sk
      and ss_item_sk = i_item_sk
      and ss_item_sk = sr_item_sk
      and ss_ticket_number = sr_ticket_number
      and ss_item_sk = cs_ui.cs_item_sk
      and c_current_cdemo_sk = cd2.cd_demo_sk
      and c_current_hdemo_sk = hd2.hd_demo_sk
      and c_current_addr_sk = ad2.ca_address_sk
      and c_first_sales_date_sk = d2.d_date_sk
      and c_first_shipto_date_sk = d3.d_date_sk
      and ss_promo_sk = p_promo_sk
      and hd1.hd_income_band_sk = ib1.ib_income_band_sk
      and hd2.hd_income_band_sk = ib2.ib_income_band_sk
      and cd1.cd_marital_status <> cd2.cd_marital_status
      and i_color in ('purple', 'burlywood', 'indian', 'spring', 'floral', 'medium')
      and i_current_price between 64 and 64 + 10
      and i_current_price between 64 + 1 and 64 + 15
    group by i_product_name, i_item_sk, s_store_name, s_zip,
             ad1.ca_street_number, ad1.ca_street_name, ad1.ca_city, ad1.ca_zip,
             ad2.ca_street_number, ad2.ca_street_name, ad2.ca_city, ad2.ca_zip,
             d1.d_year, d2.d_year, d3.d_year
)
select cs1.product_name, cs1.store_name, cs1.store_zip,
       cs1.b_street_number, cs1.b_street_name, cs1.b_city, cs1.b_zip,
       cs1.c_street_number, cs1.c_street_name, cs1.c_city, cs1.c_zip,
       cs1.syear as syear1, cs1.cnt as cnt1, cs1.s1 as s11, cs1.s2 as s21, cs1.s3 as s31,
       cs2.s1 as s12, cs2.s2 as s22, cs2.s3 as s32, cs2.syear as syear2, cs2.cnt as cnt2
from cross_sales cs1, cross_sales cs2
where cs1.item_sk = cs2.item_sk
  and cs1.syear = 1999
  and cs2.syear = 1999 + 1
  and cs2.cnt <= cs1.cnt
  and cs1.store_name = cs2.store_name
  and cs1.store_zip = cs2.store_zip
order by cs1.product_name, cs1.store_name, cnt2, s12, s22
""",
    6: """
SELECT
  a.ca_state STATE
, count(*) cnt
FROM
  customer_address a
, customer c
, store_sales s
, date_dim d
, item i
WHERE (a.ca_address_sk = c.c_current_addr_sk)
   AND (c.c_customer_sk = s.ss_customer_sk)
   AND (s.ss_sold_date_sk = d.d_date_sk)
   AND (s.ss_item_sk = i.i_item_sk)
   AND (d.d_month_seq = (
      SELECT DISTINCT d_month_seq
      FROM
        date_dim
      WHERE (d_year = 2001)
         AND (d_moy = 1)
   ))
   AND (i.i_current_price > (1.2 * (
         SELECT avg(j.i_current_price)
         FROM
           item j
         WHERE (j.i_category = i.i_category)
      )))
GROUP BY a.ca_state
HAVING (count(*) >= 10)
ORDER BY cnt ASC, a.ca_state ASC
LIMIT 100
""",
    12: """
SELECT
  i_item_id
, i_item_desc
, i_category
, i_class
, i_current_price
, sum(ws_ext_sales_price) itemrevenue
, ((sum(ws_ext_sales_price) * 100) / sum(sum(ws_ext_sales_price)) OVER (PARTITION BY i_class)) revenueratio
FROM
  web_sales
, item
, date_dim
WHERE (ws_item_sk = i_item_sk)
   AND (i_category IN ('Sports', 'Books', 'Home'))
   AND (ws_sold_date_sk = d_date_sk)
   AND (CAST(d_date AS DATE) BETWEEN CAST('1999-02-22' AS DATE) AND (CAST('1999-02-22' AS DATE) + INTERVAL  '30' DAY))
GROUP BY i_item_id, i_item_desc, i_category, i_class, i_current_price
ORDER BY i_category ASC, i_class ASC, i_item_id ASC, i_item_desc ASC, revenueratio ASC
LIMIT 100
""",
    13: """
SELECT
  avg(ss_quantity)
, avg(ss_ext_sales_price)
, avg(ss_ext_wholesale_cost)
, sum(ss_ext_wholesale_cost)
FROM
  store_sales
, store
, customer_demographics
, household_demographics
, customer_address
, date_dim
WHERE (s_store_sk = ss_store_sk)
   AND (ss_sold_date_sk = d_date_sk)
   AND (d_year = 2001)
   AND (((ss_hdemo_sk = hd_demo_sk)
         AND (cd_demo_sk = ss_cdemo_sk)
         AND (cd_marital_status = 'M')
         AND (cd_education_status = 'Advanced Degree')
         AND (ss_sales_price BETWEEN 100.00 AND 150.00)
         AND (hd_dep_count = 3))
      OR ((ss_hdemo_sk = hd_demo_sk)
         AND (cd_demo_sk = ss_cdemo_sk)
         AND (cd_marital_status = 'S')
         AND (cd_education_status = 'College')
         AND (ss_sales_price BETWEEN 50.00 AND 100.00)
         AND (hd_dep_count = 1))
      OR ((ss_hdemo_sk = hd_demo_sk)
         AND (cd_demo_sk = ss_cdemo_sk)
         AND (cd_marital_status = 'W')
         AND (cd_education_status = '2 yr Degree')
         AND (ss_sales_price BETWEEN 150.00 AND 200.00)
         AND (hd_dep_count = 1)))
   AND (((ss_addr_sk = ca_address_sk)
         AND (ca_country = 'United States')
         AND (ca_state IN ('TX'      , 'OH'      , 'TX'))
         AND (ss_net_profit BETWEEN 100 AND 200))
      OR ((ss_addr_sk = ca_address_sk)
         AND (ca_country = 'United States')
         AND (ca_state IN ('OR'      , 'NM'      , 'KY'))
         AND (ss_net_profit BETWEEN 150 AND 300))
      OR ((ss_addr_sk = ca_address_sk)
         AND (ca_country = 'United States')
         AND (ca_state IN ('VA'      , 'TX'      , 'MS'))
         AND (ss_net_profit BETWEEN 50 AND 250)))
""",
    15: """
SELECT
  ca_zip
, sum(cs_sales_price)
FROM
  catalog_sales
, customer
, customer_address
, date_dim
WHERE (cs_bill_customer_sk = c_customer_sk)
   AND (c_current_addr_sk = ca_address_sk)
   AND ((substr(ca_zip, 1, 5) IN ('85669'   , '86197'   , '88274'   , '83405'   , '86475'   , '85392'   , '85460'   , '80348'   , '81792'))
      OR (ca_state IN ('CA'   , 'WA'   , 'GA'))
      OR (cs_sales_price > 500))
   AND (cs_sold_date_sk = d_date_sk)
   AND (d_qoy = 2)
   AND (d_year = 2001)
GROUP BY ca_zip
ORDER BY ca_zip ASC
LIMIT 100
""",
    19: """
SELECT
  i_brand_id brand_id
, i_brand brand
, i_manufact_id
, i_manufact
, sum(ss_ext_sales_price) ext_price
FROM
  date_dim
, store_sales
, item
, customer
, customer_address
, store
WHERE (d_date_sk = ss_sold_date_sk)
   AND (ss_item_sk = i_item_sk)
   AND (i_manager_id = 8)
   AND (d_moy = 11)
   AND (d_year = 1998)
   AND (ss_customer_sk = c_customer_sk)
   AND (c_current_addr_sk = ca_address_sk)
   AND (substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5))
   AND (ss_store_sk = s_store_sk)
GROUP BY i_brand, i_brand_id, i_manufact_id, i_manufact
ORDER BY ext_price DESC, i_brand ASC, i_brand_id ASC, i_manufact_id ASC, i_manufact ASC
LIMIT 100
""",
    20: """
SELECT
  i_item_id
, i_item_desc
, i_category
, i_class
, i_current_price
, sum(cs_ext_sales_price) itemrevenue
, ((sum(cs_ext_sales_price) * 100) / sum(sum(cs_ext_sales_price)) OVER (PARTITION BY i_class)) revenueratio
FROM
  catalog_sales
, item
, date_dim
WHERE (cs_item_sk = i_item_sk)
   AND (i_category IN ('Sports', 'Books', 'Home'))
   AND (cs_sold_date_sk = d_date_sk)
   AND (CAST(d_date AS DATE) BETWEEN CAST('1999-02-22' AS DATE) AND (CAST('1999-02-22' AS DATE) + INTERVAL  '30' DAY))
GROUP BY i_item_id, i_item_desc, i_category, i_class, i_current_price
ORDER BY i_category ASC, i_class ASC, i_item_id ASC, i_item_desc ASC, revenueratio ASC
LIMIT 100
""",
    21: """
SELECT *
FROM
  (
   SELECT
     w_warehouse_name
   , i_item_id
   , sum((CASE WHEN (CAST(d_date AS DATE) < CAST('2000-03-11' AS DATE)) THEN inv_quantity_on_hand ELSE 0 END)) inv_before
   , sum((CASE WHEN (CAST(d_date AS DATE) >= CAST('2000-03-11' AS DATE)) THEN inv_quantity_on_hand ELSE 0 END)) inv_after
   FROM
     inventory
   , warehouse
   , item
   , date_dim
   WHERE (i_current_price BETWEEN 0.99 AND 1.49)
      AND (i_item_sk = inv_item_sk)
      AND (inv_warehouse_sk = w_warehouse_sk)
      AND (inv_date_sk = d_date_sk)
      AND (d_date BETWEEN (CAST('2000-03-11' AS DATE) - INTERVAL  '30' DAY) AND (CAST('2000-03-11' AS DATE) + INTERVAL  '30' DAY))
   GROUP BY w_warehouse_name, i_item_id
)  x
WHERE ((CASE WHEN (inv_before > 0) THEN (CAST(inv_after AS DECIMAL(7,2)) / inv_before) ELSE null END) BETWEEN (2.00 / 3.00) AND (3.00 / 2.00))
ORDER BY w_warehouse_name ASC, i_item_id ASC
LIMIT 100
""",
    25: """
SELECT
  i_item_id
, i_item_desc
, s_store_id
, s_store_name
, sum(ss_net_profit) store_sales_profit
, sum(sr_net_loss) store_returns_loss
, sum(cs_net_profit) catalog_sales_profit
FROM
  store_sales
, store_returns
, catalog_sales
, date_dim d1
, date_dim d2
, date_dim d3
, store
, item
WHERE (d1.d_moy = 4)
   AND (d1.d_year = 2001)
   AND (d1.d_date_sk = ss_sold_date_sk)
   AND (i_item_sk = ss_item_sk)
   AND (s_store_sk = ss_store_sk)
   AND (ss_customer_sk = sr_customer_sk)
   AND (ss_item_sk = sr_item_sk)
   AND (ss_ticket_number = sr_ticket_number)
   AND (sr_returned_date_sk = d2.d_date_sk)
   AND (d2.d_moy BETWEEN 4 AND 10)
   AND (d2.d_year = 2001)
   AND (sr_customer_sk = cs_bill_customer_sk)
   AND (sr_item_sk = cs_item_sk)
   AND (cs_sold_date_sk = d3.d_date_sk)
   AND (d3.d_moy BETWEEN 4 AND 10)
   AND (d3.d_year = 2001)
GROUP BY i_item_id, i_item_desc, s_store_id, s_store_name
ORDER BY i_item_id ASC, i_item_desc ASC, s_store_id ASC, s_store_name ASC
LIMIT 100
""",
    26: """
SELECT
  i_item_id
, avg(cs_quantity) agg1
, avg(cs_list_price) agg2
, avg(cs_coupon_amt) agg3
, avg(cs_sales_price) agg4
FROM
  catalog_sales
, customer_demographics
, date_dim
, item
, promotion
WHERE (cs_sold_date_sk = d_date_sk)
   AND (cs_item_sk = i_item_sk)
   AND (cs_bill_cdemo_sk = cd_demo_sk)
   AND (cs_promo_sk = p_promo_sk)
   AND (cd_gender = 'M')
   AND (cd_marital_status = 'S')
   AND (cd_education_status = 'College')
   AND ((p_channel_email = 'N')
      OR (p_channel_event = 'N'))
   AND (d_year = 2000)
GROUP BY i_item_id
ORDER BY i_item_id ASC
LIMIT 100
""",
    29: """
SELECT
  i_item_id
, i_item_desc
, s_store_id
, s_store_name
, sum(ss_quantity) store_sales_quantity
, sum(sr_return_quantity) store_returns_quantity
, sum(cs_quantity) catalog_sales_quantity
FROM
  store_sales
, store_returns
, catalog_sales
, date_dim d1
, date_dim d2
, date_dim d3
, store
, item
WHERE (d1.d_moy = 9)
   AND (d1.d_year = 1999)
   AND (d1.d_date_sk = ss_sold_date_sk)
   AND (i_item_sk = ss_item_sk)
   AND (s_store_sk = ss_store_sk)
   AND (ss_customer_sk = sr_customer_sk)
   AND (ss_item_sk = sr_item_sk)
   AND (ss_ticket_number = sr_ticket_number)
   AND (sr_returned_date_sk = d2.d_date_sk)
   AND (d2.d_moy BETWEEN 9 AND (9 + 3))
   AND (d2.d_year = 1999)
   AND (sr_customer_sk = cs_bill_customer_sk)
   AND (sr_item_sk = cs_item_sk)
   AND (cs_sold_date_sk = d3.d_date_sk)
   AND (d3.d_year IN (1999, (1999 + 1), (1999 + 2)))
GROUP BY i_item_id, i_item_desc, s_store_id, s_store_name
ORDER BY i_item_id ASC, i_item_desc ASC, s_store_id ASC, s_store_name ASC
LIMIT 100
""",
    37: """
SELECT
  i_item_id
, i_item_desc
, i_current_price
FROM
  item
, inventory
, date_dim
, catalog_sales
WHERE (i_current_price BETWEEN 68 AND (68 + 30))
   AND (inv_item_sk = i_item_sk)
   AND (d_date_sk = inv_date_sk)
   AND (CAST(d_date AS DATE) BETWEEN CAST('2000-02-01' AS DATE) AND (CAST('2000-02-01' AS DATE) + INTERVAL  '60' DAY))
   AND (i_manufact_id IN (677, 940, 694, 808))
   AND (inv_quantity_on_hand BETWEEN 100 AND 500)
   AND (cs_item_sk = i_item_sk)
GROUP BY i_item_id, i_item_desc, i_current_price
ORDER BY i_item_id ASC
LIMIT 100
""",
    43: """
SELECT
  s_store_name
, s_store_id
, sum((CASE WHEN (d_day_name = 'Sunday') THEN ss_sales_price ELSE null END)) sun_sales
, sum((CASE WHEN (d_day_name = 'Monday') THEN ss_sales_price ELSE null END)) mon_sales
, sum((CASE WHEN (d_day_name = 'Tuesday') THEN ss_sales_price ELSE null END)) tue_sales
, sum((CASE WHEN (d_day_name = 'Wednesday') THEN ss_sales_price ELSE null END)) wed_sales
, sum((CASE WHEN (d_day_name = 'Thursday') THEN ss_sales_price ELSE null END)) thu_sales
, sum((CASE WHEN (d_day_name = 'Friday') THEN ss_sales_price ELSE null END)) fri_sales
, sum((CASE WHEN (d_day_name = 'Saturday') THEN ss_sales_price ELSE null END)) sat_sales
FROM
  date_dim
, store_sales
, store
WHERE (d_date_sk = ss_sold_date_sk)
   AND (s_store_sk = ss_store_sk)
   AND (s_gmt_offset = -5)
   AND (d_year = 2000)
GROUP BY s_store_name, s_store_id
ORDER BY s_store_name ASC, s_store_id ASC, sun_sales ASC, mon_sales ASC, tue_sales ASC, wed_sales ASC, thu_sales ASC, fri_sales ASC, sat_sales ASC
LIMIT 100
""",
    46: """
SELECT
  c_last_name
, c_first_name
, ca_city
, bought_city
, ss_ticket_number
, amt
, profit
FROM
  (
   SELECT
     ss_ticket_number
   , ss_customer_sk
   , ca_city bought_city
   , sum(ss_coupon_amt) amt
   , sum(ss_net_profit) profit
   FROM
     store_sales
   , date_dim
   , store
   , household_demographics
   , customer_address
   WHERE (store_sales.ss_sold_date_sk = date_dim.d_date_sk)
      AND (store_sales.ss_store_sk = store.s_store_sk)
      AND (store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk)
      AND (store_sales.ss_addr_sk = customer_address.ca_address_sk)
      AND ((household_demographics.hd_dep_count = 4)
         OR (household_demographics.hd_vehicle_count = 3))
      AND (date_dim.d_dow IN (6   , 0))
      AND (date_dim.d_year IN (1999   , (1999 + 1)   , (1999 + 2)))
      AND (store.s_city IN ('Fairview'   , 'Midway'   , 'Fairview'   , 'Fairview'   , 'Fairview'))
   GROUP BY ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city
)  dn
, customer
, customer_address current_addr
WHERE (ss_customer_sk = c_customer_sk)
   AND (customer.c_current_addr_sk = current_addr.ca_address_sk)
   AND (current_addr.ca_city <> bought_city)
ORDER BY c_last_name ASC, c_first_name ASC, ca_city ASC, bought_city ASC, ss_ticket_number ASC
LIMIT 100
""",
    48: """
SELECT sum(ss_quantity)
FROM
  store_sales
, store
, customer_demographics
, customer_address
, date_dim
WHERE (s_store_sk = ss_store_sk)
   AND (ss_sold_date_sk = d_date_sk)
   AND (d_year = 2000)
   AND (((cd_demo_sk = ss_cdemo_sk)
         AND (cd_marital_status = 'M')
         AND (cd_education_status = '4 yr Degree')
         AND (ss_sales_price BETWEEN 100.00 AND 150.00))
      OR ((cd_demo_sk = ss_cdemo_sk)
         AND (cd_marital_status = 'D')
         AND (cd_education_status = '2 yr Degree')
         AND (ss_sales_price BETWEEN 50.00 AND 100.00))
      OR ((cd_demo_sk = ss_cdemo_sk)
         AND (cd_marital_status = 'S')
         AND (cd_education_status = 'College')
         AND (ss_sales_price BETWEEN 150.00 AND 200.00)))
   AND (((ss_addr_sk = ca_address_sk)
         AND (ca_country = 'United States')
         AND (ca_state IN ('CO'      , 'OH'      , 'TX'))
         AND (ss_net_profit BETWEEN 0 AND 2000))
      OR ((ss_addr_sk = ca_address_sk)
         AND (ca_country = 'United States')
         AND (ca_state IN ('OR'      , 'MN'      , 'KY'))
         AND (ss_net_profit BETWEEN 150 AND 3000))
      OR ((ss_addr_sk = ca_address_sk)
         AND (ca_country = 'United States')
         AND (ca_state IN ('VA'      , 'CA'      , 'MS'))
         AND (ss_net_profit BETWEEN 50 AND 25000)))
""",
    50: """
SELECT
  s_store_name
, s_company_id
, s_street_number
, s_street_name
, s_street_type
, s_suite_number
, s_city
, s_county
, s_state
, s_zip
, sum((CASE WHEN ((sr_returned_date_sk - ss_sold_date_sk) <= 30) THEN 1 ELSE 0 END)) "30 days"
, sum((CASE WHEN ((sr_returned_date_sk - ss_sold_date_sk) > 30)
   AND ((sr_returned_date_sk - ss_sold_date_sk) <= 60) THEN 1 ELSE 0 END)) "31-60 days"
, sum((CASE WHEN ((sr_returned_date_sk - ss_sold_date_sk) > 60)
   AND ((sr_returned_date_sk - ss_sold_date_sk) <= 90) THEN 1 ELSE 0 END)) "61-90 days"
, sum((CASE WHEN ((sr_returned_date_sk - ss_sold_date_sk) > 90)
   AND ((sr_returned_date_sk - ss_sold_date_sk) <= 120) THEN 1 ELSE 0 END)) "91-120 days"
, sum((CASE WHEN ((sr_returned_date_sk - ss_sold_date_sk) > 120) THEN 1 ELSE 0 END)) ">120 days"
FROM
  store_sales
, store_returns
, store
, date_dim d1
, date_dim d2
WHERE (d2.d_year = 2001)
   AND (d2.d_moy = 8)
   AND (ss_ticket_number = sr_ticket_number)
   AND (ss_item_sk = sr_item_sk)
   AND (ss_sold_date_sk = d1.d_date_sk)
   AND (sr_returned_date_sk = d2.d_date_sk)
   AND (ss_customer_sk = sr_customer_sk)
   AND (ss_store_sk = s_store_sk)
GROUP BY s_store_name, s_company_id, s_street_number, s_street_name, s_street_type, s_suite_number, s_city, s_county, s_state, s_zip
ORDER BY s_store_name ASC, s_company_id ASC, s_street_number ASC, s_street_name ASC, s_street_type ASC, s_suite_number ASC, s_city ASC, s_county ASC, s_state ASC, s_zip ASC
LIMIT 100
""",
    53: """
SELECT *
FROM
  (
   SELECT
     i_manufact_id
   , sum(ss_sales_price) sum_sales
   , avg(sum(ss_sales_price)) OVER (PARTITION BY i_manufact_id) avg_quarterly_sales
   FROM
     item
   , store_sales
   , date_dim
   , store
   WHERE (ss_item_sk = i_item_sk)
      AND (ss_sold_date_sk = d_date_sk)
      AND (ss_store_sk = s_store_sk)
      AND (d_month_seq IN (1200   , (1200 + 1)   , (1200 + 2)   , (1200 + 3)   , (1200 + 4)   , (1200 + 5)   , (1200 + 6)   , (1200 + 7)   , (1200 + 8)   , (1200 + 9)   , (1200 + 10)   , (1200 + 11)))
      AND (((i_category IN ('Books'         , 'Children'         , 'Electronics'))
            AND (i_class IN ('personal'         , 'portable'         , 'reference'         , 'self-help'))
            AND (i_brand IN ('scholaramalgamalg #14'         , 'scholaramalgamalg #7'         , 'exportiunivamalg #9'         , 'scholaramalgamalg #9')))
         OR ((i_category IN ('Women'         , 'Music'         , 'Men'))
            AND (i_class IN ('accessories'         , 'classical'         , 'fragrances'         , 'pants'))
            AND (i_brand IN ('amalgimporto #1'         , 'edu packscholar #1'         , 'exportiimporto #1'         , 'importoamalg #1'))))
   GROUP BY i_manufact_id, d_qoy
)  tmp1
WHERE ((CASE WHEN (avg_quarterly_sales > 0) THEN (abs((CAST(sum_sales AS DECIMAL(38,4)) - avg_quarterly_sales)) / avg_quarterly_sales) ELSE null END) > 0.1)
ORDER BY avg_quarterly_sales ASC, sum_sales ASC, i_manufact_id ASC
LIMIT 100
""",
    59: """
WITH
  wss AS (
   SELECT
     d_week_seq
   , ss_store_sk
   , sum((CASE WHEN (d_day_name = 'Sunday') THEN ss_sales_price ELSE null END)) sun_sales
   , sum((CASE WHEN (d_day_name = 'Monday') THEN ss_sales_price ELSE null END)) mon_sales
   , sum((CASE WHEN (d_day_name = 'Tuesday') THEN ss_sales_price ELSE null END)) tue_sales
   , sum((CASE WHEN (d_day_name = 'Wednesday') THEN ss_sales_price ELSE null END)) wed_sales
   , sum((CASE WHEN (d_day_name = 'Thursday') THEN ss_sales_price ELSE null END)) thu_sales
   , sum((CASE WHEN (d_day_name = 'Friday') THEN ss_sales_price ELSE null END)) fri_sales
   , sum((CASE WHEN (d_day_name = 'Saturday') THEN ss_sales_price ELSE null END)) sat_sales
   FROM
     store_sales
   , date_dim
   WHERE (d_date_sk = ss_sold_date_sk)
   GROUP BY d_week_seq, ss_store_sk
)
SELECT
  s_store_name1
, s_store_id1
, d_week_seq1
, (sun_sales1 / sun_sales2)
, (mon_sales1 / mon_sales2)
, (tue_sales1 / tue_sales2)
, (wed_sales1 / wed_sales2)
, (thu_sales1 / thu_sales2)
, (fri_sales1 / fri_sales2)
, (sat_sales1 / sat_sales2)
FROM
  (
   SELECT
     s_store_name s_store_name1
   , wss.d_week_seq d_week_seq1
   , s_store_id s_store_id1
   , sun_sales sun_sales1
   , mon_sales mon_sales1
   , tue_sales tue_sales1
   , wed_sales wed_sales1
   , thu_sales thu_sales1
   , fri_sales fri_sales1
   , sat_sales sat_sales1
   FROM
     wss
   , store
   , date_dim d
   WHERE (d.d_week_seq = wss.d_week_seq)
      AND (ss_store_sk = s_store_sk)
      AND (d_month_seq BETWEEN 1212 AND (1212 + 11))
)  y
, (
   SELECT
     s_store_name s_store_name2
   , wss.d_week_seq d_week_seq2
   , s_store_id s_store_id2
   , sun_sales sun_sales2
   , mon_sales mon_sales2
   , tue_sales tue_sales2
   , wed_sales wed_sales2
   , thu_sales thu_sales2
   , fri_sales fri_sales2
   , sat_sales sat_sales2
   FROM
     wss
   , store
   , date_dim d
   WHERE (d.d_week_seq = wss.d_week_seq)
      AND (ss_store_sk = s_store_sk)
      AND (d_month_seq BETWEEN (1212 + 12) AND (1212 + 23))
)  x
WHERE (s_store_id1 = s_store_id2)
   AND (d_week_seq1 = (d_week_seq2 - 52))
ORDER BY s_store_name1 ASC, s_store_id1 ASC, d_week_seq1 ASC
LIMIT 100
""",
    62: """
SELECT
  substr(w_warehouse_name, 1, 20)
, sm_type
, web_name
, sum((CASE WHEN ((ws_ship_date_sk - ws_sold_date_sk) <= 30) THEN 1 ELSE 0 END)) "30 days"
, sum((CASE WHEN ((ws_ship_date_sk - ws_sold_date_sk) > 30)
   AND ((ws_ship_date_sk - ws_sold_date_sk) <= 60) THEN 1 ELSE 0 END)) "31-60 days"
, sum((CASE WHEN ((ws_ship_date_sk - ws_sold_date_sk) > 60)
   AND ((ws_ship_date_sk - ws_sold_date_sk) <= 90) THEN 1 ELSE 0 END)) "61-90 days"
, sum((CASE WHEN ((ws_ship_date_sk - ws_sold_date_sk) > 90)
   AND ((ws_ship_date_sk - ws_sold_date_sk) <= 120) THEN 1 ELSE 0 END)) "91-120 days"
, sum((CASE WHEN ((ws_ship_date_sk - ws_sold_date_sk) > 120) THEN 1 ELSE 0 END)) ">120 days"
FROM
  web_sales
, warehouse
, ship_mode
, web_site
, date_dim
WHERE (d_month_seq BETWEEN 1200 AND (1200 + 11))
   AND (ws_ship_date_sk = d_date_sk)
   AND (ws_warehouse_sk = w_warehouse_sk)
   AND (ws_ship_mode_sk = sm_ship_mode_sk)
   AND (ws_web_site_sk = web_site_sk)
GROUP BY substr(w_warehouse_name, 1, 20), sm_type, web_name
ORDER BY substr(w_warehouse_name, 1, 20) ASC, sm_type ASC, web_name ASC
LIMIT 100
""",
    63: """
SELECT *
FROM
  (
   SELECT
     i_manager_id
   , sum(ss_sales_price) sum_sales
   , avg(sum(ss_sales_price)) OVER (PARTITION BY i_manager_id) avg_monthly_sales
   FROM
     item
   , store_sales
   , date_dim
   , store
   WHERE (ss_item_sk = i_item_sk)
      AND (ss_sold_date_sk = d_date_sk)
      AND (ss_store_sk = s_store_sk)
      AND (d_month_seq IN (1200   , (1200 + 1)   , (1200 + 2)   , (1200 + 3)   , (1200 + 4)   , (1200 + 5)   , (1200 + 6)   , (1200 + 7)   , (1200 + 8)   , (1200 + 9)   , (1200 + 10)   , (1200 + 11)))
      AND (((i_category IN ('Books'         , 'Children'         , 'Electronics'))
            AND (i_class IN ('personal'         , 'portable'         , 'refernece'         , 'self-help'))
            AND (i_brand IN ('scholaramalgamalg #14'         , 'scholaramalgamalg #7'         , 'exportiunivamalg #9'         , 'scholaramalgamalg #9')))
         OR ((i_category IN ('Women'         , 'Music'         , 'Men'))
            AND (i_class IN ('accessories'         , 'classical'         , 'fragrances'         , 'pants'))
            AND (i_brand IN ('amalgimporto #1'         , 'edu packscholar #1'         , 'exportiimporto #1'         , 'importoamalg #1'))))
   GROUP BY i_manager_id, d_moy
)  tmp1
WHERE ((CASE WHEN (avg_monthly_sales > 0) THEN (abs((sum_sales - avg_monthly_sales)) / avg_monthly_sales) ELSE null END) > 0.1)
ORDER BY i_manager_id ASC, avg_monthly_sales ASC, sum_sales ASC
LIMIT 100
""",
    65: """
SELECT
  s_store_name
, i_item_desc
, sc.revenue
, i_current_price
, i_wholesale_cost
, i_brand
FROM
  store
, item
, (
   SELECT
     ss_store_sk
   , avg(revenue) ave
   FROM
     (
      SELECT
        ss_store_sk
      , ss_item_sk
      , sum(ss_sales_price) revenue
      FROM
        store_sales
      , date_dim
      WHERE (ss_sold_date_sk = d_date_sk)
         AND (d_month_seq BETWEEN 1176 AND (1176 + 11))
      GROUP BY ss_store_sk, ss_item_sk
   )  sa
   GROUP BY ss_store_sk
)  sb
, (
   SELECT
     ss_store_sk
   , ss_item_sk
   , sum(ss_sales_price) revenue
   FROM
     store_sales
   , date_dim
   WHERE (ss_sold_date_sk = d_date_sk)
      AND (d_month_seq BETWEEN 1176 AND (1176 + 11))
   GROUP BY ss_store_sk, ss_item_sk
)  sc
WHERE (sb.ss_store_sk = sc.ss_store_sk)
   AND (sc.revenue <= (0.1 * sb.ave))
   AND (s_store_sk = sc.ss_store_sk)
   AND (i_item_sk = sc.ss_item_sk)
ORDER BY s_store_name ASC, i_item_desc ASC,
   -- additional columns to assure results stability for larger scale factors; this is a deviation from TPC-DS specification
   i_brand ASC, sc.revenue ASC
LIMIT 100
""",
    73: """
SELECT
  c_last_name
, c_first_name
, c_salutation
, c_preferred_cust_flag
, ss_ticket_number
, cnt
FROM
  (
   SELECT
     ss_ticket_number
   , ss_customer_sk
   , count(*) cnt
   FROM
     store_sales
   , date_dim
   , store
   , household_demographics
   WHERE (store_sales.ss_sold_date_sk = date_dim.d_date_sk)
      AND (store_sales.ss_store_sk = store.s_store_sk)
      AND (store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk)
      AND (date_dim.d_dom BETWEEN 1 AND 2)
      AND ((household_demographics.hd_buy_potential = '>10000')
         OR (household_demographics.hd_buy_potential = 'Unknown'))
      AND (household_demographics.hd_vehicle_count > 0)
      AND ((CASE WHEN (household_demographics.hd_vehicle_count > 0) THEN (CAST(household_demographics.hd_dep_count AS DECIMAL(7,2)) / household_demographics.hd_vehicle_count) ELSE null END) > 1)
      AND (date_dim.d_year IN (1999   , (1999 + 1)   , (1999 + 2)))
      AND (store.s_county IN ('Williamson County'   , 'Franklin Parish'   , 'Bronx County'   , 'Orange County'))
   GROUP BY ss_ticket_number, ss_customer_sk
)  dj
, customer
WHERE (ss_customer_sk = c_customer_sk)
   AND (cnt BETWEEN 1 AND 5)
ORDER BY cnt DESC, c_last_name ASC,
   -- additional column to assure results stability for larger scale factors; this is a deviation from TPC-DS specification
   ss_ticket_number ASC
""",
    79: """
SELECT
  c_last_name
, c_first_name
, substr(s_city, 1, 30)
, ss_ticket_number
, amt
, profit
FROM
  (
   SELECT
     ss_ticket_number
   , ss_customer_sk
   , store.s_city
   , sum(ss_coupon_amt) amt
   , sum(ss_net_profit) profit
   FROM
     store_sales
   , date_dim
   , store
   , household_demographics
   WHERE (store_sales.ss_sold_date_sk = date_dim.d_date_sk)
      AND (store_sales.ss_store_sk = store.s_store_sk)
      AND (store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk)
      AND ((household_demographics.hd_dep_count = 6)
         OR (household_demographics.hd_vehicle_count > 2))
      AND (date_dim.d_dow = 1)
      AND (date_dim.d_year IN (1999   , (1999 + 1)   , (1999 + 2)))
      AND (store.s_number_employees BETWEEN 200 AND 295)
   GROUP BY ss_ticket_number, ss_customer_sk, ss_addr_sk, store.s_city
)  ms
, customer
WHERE (ss_customer_sk = c_customer_sk)
ORDER BY c_last_name ASC, c_first_name ASC, substr(s_city, 1, 30) ASC, profit ASC
LIMIT 100
""",
    82: """
SELECT
  i_item_id
, i_item_desc
, i_current_price
FROM
  item
, inventory
, date_dim
, store_sales
WHERE (i_current_price BETWEEN 62 AND (62 + 30))
   AND (inv_item_sk = i_item_sk)
   AND (d_date_sk = inv_date_sk)
   AND (CAST(d_date AS DATE) BETWEEN CAST('2000-05-25' AS DATE) AND (CAST('2000-05-25' AS DATE) + INTERVAL  '60' DAY))
   AND (i_manufact_id IN (129, 270, 821, 423))
   AND (inv_quantity_on_hand BETWEEN 100 AND 500)
   AND (ss_item_sk = i_item_sk)
GROUP BY i_item_id, i_item_desc, i_current_price
ORDER BY i_item_id ASC
LIMIT 100
""",
    88: """
SELECT *
FROM
  (
   SELECT count(*) h8_30_to_9
   FROM
     store_sales
   , household_demographics
   , time_dim
   , store
   WHERE (ss_sold_time_sk = time_dim.t_time_sk)
      AND (ss_hdemo_sk = household_demographics.hd_demo_sk)
      AND (ss_store_sk = s_store_sk)
      AND (time_dim.t_hour = 8)
      AND (time_dim.t_minute >= 30)
      AND (((household_demographics.hd_dep_count = 4)
            AND (household_demographics.hd_vehicle_count <= (4 + 2)))
         OR ((household_demographics.hd_dep_count = 2)
            AND (household_demographics.hd_vehicle_count <= (2 + 2)))
         OR ((household_demographics.hd_dep_count = 0)
            AND (household_demographics.hd_vehicle_count <= (0 + 2))))
      AND (store.s_store_name = 'ese')
)  s1
, (
   SELECT count(*) h9_to_9_30
   FROM
     store_sales
   , household_demographics
   , time_dim
   , store
   WHERE (ss_sold_time_sk = time_dim.t_time_sk)
      AND (ss_hdemo_sk = household_demographics.hd_demo_sk)
      AND (ss_store_sk = s_store_sk)
      AND (time_dim.t_hour = 9)
      AND (time_dim.t_minute < 30)
      AND (((household_demographics.hd_dep_count = 4)
            AND (household_demographics.hd_vehicle_count <= (4 + 2)))
         OR ((household_demographics.hd_dep_count = 2)
            AND (household_demographics.hd_vehicle_count <= (2 + 2)))
         OR ((household_demographics.hd_dep_count = 0)
            AND (household_demographics.hd_vehicle_count <= (0 + 2))))
      AND (store.s_store_name = 'ese')
)  s2
, (
   SELECT count(*) h9_30_to_10
   FROM
     store_sales
   , household_demographics
   , time_dim
   , store
   WHERE (ss_sold_time_sk = time_dim.t_time_sk)
      AND (ss_hdemo_sk = household_demographics.hd_demo_sk)
      AND (ss_store_sk = s_store_sk)
      AND (time_dim.t_hour = 9)
      AND (time_dim.t_minute >= 30)
      AND (((household_demographics.hd_dep_count = 4)
            AND (household_demographics.hd_vehicle_count <= (4 + 2)))
         OR ((household_demographics.hd_dep_count = 2)
            AND (household_demographics.hd_vehicle_count <= (2 + 2)))
         OR ((household_demographics.hd_dep_count = 0)
            AND (household_demographics.hd_vehicle_count <= (0 + 2))))
      AND (store.s_store_name = 'ese')
)  s3
, (
   SELECT count(*) h10_to_10_30
   FROM
     store_sales
   , household_demographics
   , time_dim
   , store
   WHERE (ss_sold_time_sk = time_dim.t_time_sk)
      AND (ss_hdemo_sk = household_demographics.hd_demo_sk)
      AND (ss_store_sk = s_store_sk)
      AND (time_dim.t_hour = 10)
      AND (time_dim.t_minute < 30)
      AND (((household_demographics.hd_dep_count = 4)
            AND (household_demographics.hd_vehicle_count <= (4 + 2)))
         OR ((household_demographics.hd_dep_count = 2)
            AND (household_demographics.hd_vehicle_count <= (2 + 2)))
         OR ((household_demographics.hd_dep_count = 0)
            AND (household_demographics.hd_vehicle_count <= (0 + 2))))
      AND (store.s_store_name = 'ese')
)  s4
, (
   SELECT count(*) h10_30_to_11
   FROM
     store_sales
   , household_demographics
   , time_dim
   , store
   WHERE (ss_sold_time_sk = time_dim.t_time_sk)
      AND (ss_hdemo_sk = household_demographics.hd_demo_sk)
      AND (ss_store_sk = s_store_sk)
      AND (time_dim.t_hour = 10)
      AND (time_dim.t_minute >= 30)
      AND (((household_demographics.hd_dep_count = 4)
            AND (household_demographics.hd_vehicle_count <= (4 + 2)))
         OR ((household_demographics.hd_dep_count = 2)
            AND (household_demographics.hd_vehicle_count <= (2 + 2)))
         OR ((household_demographics.hd_dep_count = 0)
            AND (household_demographics.hd_vehicle_count <= (0 + 2))))
      AND (store.s_store_name = 'ese')
)  s5
, (
   SELECT count(*) h11_to_11_30
   FROM
     store_sales
   , household_demographics
   , time_dim
   , store
   WHERE (ss_sold_time_sk = time_dim.t_time_sk)
      AND (ss_hdemo_sk = household_demographics.hd_demo_sk)
      AND (ss_store_sk = s_store_sk)
      AND (time_dim.t_hour = 11)
      AND (time_dim.t_minute < 30)
      AND (((household_demographics.hd_dep_count = 4)
            AND (household_demographics.hd_vehicle_count <= (4 + 2)))
         OR ((household_demographics.hd_dep_count = 2)
            AND (household_demographics.hd_vehicle_count <= (2 + 2)))
         OR ((household_demographics.hd_dep_count = 0)
            AND (household_demographics.hd_vehicle_count <= (0 + 2))))
      AND (store.s_store_name = 'ese')
)  s6
, (
   SELECT count(*) h11_30_to_12
   FROM
     store_sales
   , household_demographics
   , time_dim
   , store
   WHERE (ss_sold_time_sk = time_dim.t_time_sk)
      AND (ss_hdemo_sk = household_demographics.hd_demo_sk)
      AND (ss_store_sk = s_store_sk)
      AND (time_dim.t_hour = 11)
      AND (time_dim.t_minute >= 30)
      AND (((household_demographics.hd_dep_count = 4)
            AND (household_demographics.hd_vehicle_count <= (4 + 2)))
         OR ((household_demographics.hd_dep_count = 2)
            AND (household_demographics.hd_vehicle_count <= (2 + 2)))
         OR ((household_demographics.hd_dep_count = 0)
            AND (household_demographics.hd_vehicle_count <= (0 + 2))))
      AND (store.s_store_name = 'ese')
)  s7
, (
   SELECT count(*) h12_to_12_30
   FROM
     store_sales
   , household_demographics
   , time_dim
   , store
   WHERE (ss_sold_time_sk = time_dim.t_time_sk)
      AND (ss_hdemo_sk = household_demographics.hd_demo_sk)
      AND (ss_store_sk = s_store_sk)
      AND (time_dim.t_hour = 12)
      AND (time_dim.t_minute < 30)
      AND (((household_demographics.hd_dep_count = 4)
            AND (household_demographics.hd_vehicle_count <= (4 + 2)))
         OR ((household_demographics.hd_dep_count = 2)
            AND (household_demographics.hd_vehicle_count <= (2 + 2)))
         OR ((household_demographics.hd_dep_count = 0)
            AND (household_demographics.hd_vehicle_count <= (0 + 2))))
      AND (store.s_store_name = 'ese')
)  s8
""",
    89: """
SELECT *
FROM
  (
   SELECT
     i_category
   , i_class
   , i_brand
   , s_store_name
   , s_company_name
   , d_moy
   , sum(ss_sales_price) sum_sales
   , avg(sum(ss_sales_price)) OVER (PARTITION BY i_category, i_brand, s_store_name, s_company_name) avg_monthly_sales
   FROM
     item
   , store_sales
   , date_dim
   , store
   WHERE (ss_item_sk = i_item_sk)
      AND (ss_sold_date_sk = d_date_sk)
      AND (ss_store_sk = s_store_sk)
      AND (d_year IN (1999))
      AND (((i_category IN ('Books'         , 'Electronics'         , 'Sports'))
            AND (i_class IN ('computers'         , 'stereo'         , 'football')))
         OR ((i_category IN ('Men'         , 'Jewelry'         , 'Women'))
            AND (i_class IN ('shirts'         , 'birdal'         , 'dresses'))))
   GROUP BY i_category, i_class, i_brand, s_store_name, s_company_name, d_moy
)  tmp1
WHERE ((CASE WHEN (avg_monthly_sales <> 0) THEN (abs((sum_sales - avg_monthly_sales)) / avg_monthly_sales) ELSE null END) > 0.1)
ORDER BY (sum_sales - avg_monthly_sales) ASC, s_store_name ASC
LIMIT 100
""",
    90: """
SELECT (CAST(amc AS DECIMAL(15,4)) / CAST(pmc AS DECIMAL(15,4))) am_pm_ratio
FROM
  (
   SELECT count(*) amc
   FROM
     web_sales
   , household_demographics
   , time_dim
   , web_page
   WHERE (ws_sold_time_sk = time_dim.t_time_sk)
      AND (ws_ship_hdemo_sk = household_demographics.hd_demo_sk)
      AND (ws_web_page_sk = web_page.wp_web_page_sk)
      AND (time_dim.t_hour BETWEEN 8 AND (8 + 1))
      AND (household_demographics.hd_dep_count = 6)
      AND (web_page.wp_char_count BETWEEN 5000 AND 5200)
)  at
, (
   SELECT count(*) pmc
   FROM
     web_sales
   , household_demographics
   , time_dim
   , web_page
   WHERE (ws_sold_time_sk = time_dim.t_time_sk)
      AND (ws_ship_hdemo_sk = household_demographics.hd_demo_sk)
      AND (ws_web_page_sk = web_page.wp_web_page_sk)
      AND (time_dim.t_hour BETWEEN 19 AND (19 + 1))
      AND (household_demographics.hd_dep_count = 6)
      AND (web_page.wp_char_count BETWEEN 5000 AND 5200)
)  pt
ORDER BY am_pm_ratio ASC
LIMIT 100
""",
    91: """
SELECT
  cc_call_center_id Call_Center
, cc_name Call_Center_Name
, cc_manager Manager
, sum(cr_net_loss) Returns_Loss
FROM
  call_center
, catalog_returns
, date_dim
, customer
, customer_address
, customer_demographics
, household_demographics
WHERE (cr_call_center_sk = cc_call_center_sk)
   AND (cr_returned_date_sk = d_date_sk)
   AND (cr_returning_customer_sk = c_customer_sk)
   AND (cd_demo_sk = c_current_cdemo_sk)
   AND (hd_demo_sk = c_current_hdemo_sk)
   AND (ca_address_sk = c_current_addr_sk)
   AND (d_year = 1998)
   AND (d_moy = 11)
   AND (((cd_marital_status = 'M')
         AND (cd_education_status = 'Unknown'))
      OR ((cd_marital_status = 'W')
         AND (cd_education_status = 'Advanced Degree')))
   AND (hd_buy_potential LIKE 'Unknown%')
   AND (ca_gmt_offset = -7)
GROUP BY cc_call_center_id, cc_name, cc_manager, cd_marital_status, cd_education_status
ORDER BY sum(cr_net_loss) DESC
""",
    93: """
SELECT
  ss_customer_sk
, sum(act_sales) sumsales
FROM
  (
   SELECT
     ss_item_sk
   , ss_ticket_number
   , ss_customer_sk
   , (CASE WHEN (sr_return_quantity IS NOT NULL) THEN ((ss_quantity - sr_return_quantity) * ss_sales_price) ELSE (ss_quantity * ss_sales_price) END) act_sales
   FROM
     (store_sales
   LEFT JOIN store_returns ON (sr_item_sk = ss_item_sk)
      AND (sr_ticket_number = ss_ticket_number))
   , reason
   WHERE (sr_reason_sk = r_reason_sk)
      AND (r_reason_desc = 'reason 28')
)  t
GROUP BY ss_customer_sk
ORDER BY sumsales ASC, ss_customer_sk ASC
LIMIT 100
""",
    98: """
SELECT
  i_item_id
, i_item_desc
, i_category
, i_class
, i_current_price
, sum(ss_ext_sales_price) itemrevenue
, ((sum(ss_ext_sales_price) * 100) / sum(sum(ss_ext_sales_price)) OVER (PARTITION BY i_class)) revenueratio
FROM
  store_sales
, item
, date_dim
WHERE (ss_item_sk = i_item_sk)
   AND (i_category IN ('Sports', 'Books', 'Home'))
   AND (ss_sold_date_sk = d_date_sk)
   AND (CAST(d_date AS DATE) BETWEEN CAST('1999-02-22' AS DATE) AND (CAST('1999-02-22' AS DATE) + INTERVAL  '30' DAY))
GROUP BY i_item_id, i_item_desc, i_category, i_class, i_current_price
ORDER BY i_category ASC, i_class ASC, i_item_id ASC, i_item_desc ASC, revenueratio ASC
""",
    99: """
SELECT
  substr(w_warehouse_name, 1, 20)
, sm_type
, cc_name
, sum((CASE WHEN ((cs_ship_date_sk - cs_sold_date_sk) <= 30) THEN 1 ELSE 0 END)) "30 days"
, sum((CASE WHEN ((cs_ship_date_sk - cs_sold_date_sk) > 30)
   AND ((cs_ship_date_sk - cs_sold_date_sk) <= 60) THEN 1 ELSE 0 END)) "31-60 days"
, sum((CASE WHEN ((cs_ship_date_sk - cs_sold_date_sk) > 60)
   AND ((cs_ship_date_sk - cs_sold_date_sk) <= 90) THEN 1 ELSE 0 END)) "61-90 days"
, sum((CASE WHEN ((cs_ship_date_sk - cs_sold_date_sk) > 90)
   AND ((cs_ship_date_sk - cs_sold_date_sk) <= 120) THEN 1 ELSE 0 END)) "91-120 days"
, sum((CASE WHEN ((cs_ship_date_sk - cs_sold_date_sk) > 120) THEN 1 ELSE 0 END)) ">120 days"
FROM
  catalog_sales
, warehouse
, ship_mode
, call_center
, date_dim
WHERE (d_month_seq BETWEEN 1200 AND (1200 + 11))
   AND (cs_ship_date_sk = d_date_sk)
   AND (cs_warehouse_sk = w_warehouse_sk)
   AND (cs_ship_mode_sk = sm_ship_mode_sk)
   AND (cs_call_center_sk = cc_call_center_sk)
GROUP BY substr(w_warehouse_name, 1, 20), sm_type, cc_name
ORDER BY substr(w_warehouse_name, 1, 20) ASC, sm_type ASC, cc_name ASC
LIMIT 100
""",

    2: """
with wscs as (
    select ws_sold_date_sk as sold_date_sk, ws_ext_sales_price as sales_price
    from web_sales
    union all
    select cs_sold_date_sk as sold_date_sk, cs_ext_sales_price as sales_price
    from catalog_sales
),
wswscs as (
    select d_week_seq,
           sum(case when d_day_name = 'Sunday' then sales_price else null end) sun_sales,
           sum(case when d_day_name = 'Monday' then sales_price else null end) mon_sales,
           sum(case when d_day_name = 'Tuesday' then sales_price else null end) tue_sales,
           sum(case when d_day_name = 'Wednesday' then sales_price else null end) wed_sales,
           sum(case when d_day_name = 'Thursday' then sales_price else null end) thu_sales,
           sum(case when d_day_name = 'Friday' then sales_price else null end) fri_sales,
           sum(case when d_day_name = 'Saturday' then sales_price else null end) sat_sales
    from wscs, date_dim
    where d_date_sk = sold_date_sk
    group by d_week_seq
)
select d_week_seq1,
       round(sun_sales1 / sun_sales2, 2),
       round(mon_sales1 / mon_sales2, 2),
       round(tue_sales1 / tue_sales2, 2),
       round(wed_sales1 / wed_sales2, 2),
       round(thu_sales1 / thu_sales2, 2),
       round(fri_sales1 / fri_sales2, 2),
       round(sat_sales1 / sat_sales2, 2)
from (select wswscs.d_week_seq d_week_seq1, sun_sales sun_sales1,
             mon_sales mon_sales1, tue_sales tue_sales1, wed_sales wed_sales1,
             thu_sales thu_sales1, fri_sales fri_sales1, sat_sales sat_sales1
      from wswscs, date_dim
      where date_dim.d_week_seq = wswscs.d_week_seq and d_year = 2001) y,
     (select wswscs.d_week_seq d_week_seq2, sun_sales sun_sales2,
             mon_sales mon_sales2, tue_sales tue_sales2, wed_sales wed_sales2,
             thu_sales thu_sales2, fri_sales fri_sales2, sat_sales sat_sales2
      from wswscs, date_dim
      where date_dim.d_week_seq = wswscs.d_week_seq and d_year = 2002) z
where d_week_seq1 = d_week_seq2 - 53
order by d_week_seq1
""",
    4: """
WITH
  year_total AS (
   SELECT
     c_customer_id customer_id
   , c_first_name customer_first_name
   , c_last_name customer_last_name
   , c_preferred_cust_flag customer_preferred_cust_flag
   , c_birth_country customer_birth_country
   , c_login customer_login
   , c_email_address customer_email_address
   , d_year dyear
   , sum(((((ss_ext_list_price - ss_ext_wholesale_cost) - ss_ext_discount_amt) + ss_ext_sales_price) / 2)) year_total
   , 's' sale_type
   FROM
     customer
   , store_sales
   , date_dim
   WHERE (c_customer_sk = ss_customer_sk)
      AND (ss_sold_date_sk = d_date_sk)
   GROUP BY c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag, c_birth_country, c_login, c_email_address, d_year
UNION ALL    SELECT
     c_customer_id customer_id
   , c_first_name customer_first_name
   , c_last_name customer_last_name
   , c_preferred_cust_flag customer_preferred_cust_flag
   , c_birth_country customer_birth_country
   , c_login customer_login
   , c_email_address customer_email_address
   , d_year dyear
   , sum(((((cs_ext_list_price - cs_ext_wholesale_cost) - cs_ext_discount_amt) + cs_ext_sales_price) / 2)) year_total
   , 'c' sale_type
   FROM
     customer
   , catalog_sales
   , date_dim
   WHERE (c_customer_sk = cs_bill_customer_sk)
      AND (cs_sold_date_sk = d_date_sk)
   GROUP BY c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag, c_birth_country, c_login, c_email_address, d_year
UNION ALL    SELECT
     c_customer_id customer_id
   , c_first_name customer_first_name
   , c_last_name customer_last_name
   , c_preferred_cust_flag customer_preferred_cust_flag
   , c_birth_country customer_birth_country
   , c_login customer_login
   , c_email_address customer_email_address
   , d_year dyear
   , sum(((((ws_ext_list_price - ws_ext_wholesale_cost) - ws_ext_discount_amt) + ws_ext_sales_price) / 2)) year_total
   , 'w' sale_type
   FROM
     customer
   , web_sales
   , date_dim
   WHERE (c_customer_sk = ws_bill_customer_sk)
      AND (ws_sold_date_sk = d_date_sk)
   GROUP BY c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag, c_birth_country, c_login, c_email_address, d_year
) 
SELECT
  t_s_secyear.customer_id
, t_s_secyear.customer_first_name
, t_s_secyear.customer_last_name
, t_s_secyear.customer_preferred_cust_flag
FROM
  year_total t_s_firstyear
, year_total t_s_secyear
, year_total t_c_firstyear
, year_total t_c_secyear
, year_total t_w_firstyear
, year_total t_w_secyear
WHERE (t_s_secyear.customer_id = t_s_firstyear.customer_id)
   AND (t_s_firstyear.customer_id = t_c_secyear.customer_id)
   AND (t_s_firstyear.customer_id = t_c_firstyear.customer_id)
   AND (t_s_firstyear.customer_id = t_w_firstyear.customer_id)
   AND (t_s_firstyear.customer_id = t_w_secyear.customer_id)
   AND (t_s_firstyear.sale_type = 's')
   AND (t_c_firstyear.sale_type = 'c')
   AND (t_w_firstyear.sale_type = 'w')
   AND (t_s_secyear.sale_type = 's')
   AND (t_c_secyear.sale_type = 'c')
   AND (t_w_secyear.sale_type = 'w')
   AND (t_s_firstyear.dyear = 2001)
   AND (t_s_secyear.dyear = (2001 + 1))
   AND (t_c_firstyear.dyear = 2001)
   AND (t_c_secyear.dyear = (2001 + 1))
   AND (t_w_firstyear.dyear = 2001)
   AND (t_w_secyear.dyear = (2001 + 1))
   AND (t_s_firstyear.year_total > 0)
   AND (t_c_firstyear.year_total > 0)
   AND (t_w_firstyear.year_total > 0)
   AND ((CASE WHEN (t_c_firstyear.year_total > 0) THEN (t_c_secyear.year_total / t_c_firstyear.year_total) ELSE null END) > (CASE WHEN (t_s_firstyear.year_total > 0) THEN (t_s_secyear.year_total / t_s_firstyear.year_total) ELSE null END))
   AND ((CASE WHEN (t_c_firstyear.year_total > 0) THEN (t_c_secyear.year_total / t_c_firstyear.year_total) ELSE null END) > (CASE WHEN (t_w_firstyear.year_total > 0) THEN (t_w_secyear.year_total / t_w_firstyear.year_total) ELSE null END))
ORDER BY t_s_secyear.customer_id ASC, t_s_secyear.customer_first_name ASC, t_s_secyear.customer_last_name ASC, t_s_secyear.customer_preferred_cust_flag ASC
LIMIT 100
""",
    9: """
SELECT
  (CASE WHEN ((
      SELECT count(*)
      FROM
        store_sales
      WHERE (ss_quantity BETWEEN 1 AND 20)
   ) > 74129) THEN (
   SELECT avg(ss_ext_discount_amt)
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 1 AND 20)
) ELSE (
   SELECT avg(ss_net_paid)
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 1 AND 20)
) END) bucket1
, (CASE WHEN ((
      SELECT count(*)
      FROM
        store_sales
      WHERE (ss_quantity BETWEEN 21 AND 40)
   ) > 122840) THEN (
   SELECT avg(ss_ext_discount_amt)
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 21 AND 40)
) ELSE (
   SELECT avg(ss_net_paid)
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 21 AND 40)
) END) bucket2
, (CASE WHEN ((
      SELECT count(*)
      FROM
        store_sales
      WHERE (ss_quantity BETWEEN 41 AND 60)
   ) > 56580) THEN (
   SELECT avg(ss_ext_discount_amt)
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 41 AND 60)
) ELSE (
   SELECT avg(ss_net_paid)
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 41 AND 60)
) END) bucket3
, (CASE WHEN ((
      SELECT count(*)
      FROM
        store_sales
      WHERE (ss_quantity BETWEEN 61 AND 80)
   ) > 10097) THEN (
   SELECT avg(ss_ext_discount_amt)
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 61 AND 80)
) ELSE (
   SELECT avg(ss_net_paid)
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 61 AND 80)
) END) bucket4
, (CASE WHEN ((
      SELECT count(*)
      FROM
        store_sales
      WHERE (ss_quantity BETWEEN 81 AND 100)
   ) > 165306) THEN (
   SELECT avg(ss_ext_discount_amt)
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 81 AND 100)
) ELSE (
   SELECT avg(ss_net_paid)
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 81 AND 100)
) END) bucket5
FROM
  reason
WHERE (r_reason_sk = 1)
""",
    11: """
WITH
  year_total AS (
   SELECT
     c_customer_id customer_id
   , c_first_name customer_first_name
   , c_last_name customer_last_name
   , c_preferred_cust_flag customer_preferred_cust_flag
   , c_birth_country customer_birth_country
   , c_login customer_login
   , c_email_address customer_email_address
   , d_year dyear
   , sum((ss_ext_list_price - ss_ext_discount_amt)) year_total
   , 's' sale_type
   FROM
     customer
   , store_sales
   , date_dim
   WHERE (c_customer_sk = ss_customer_sk)
      AND (ss_sold_date_sk = d_date_sk)
   GROUP BY c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag, c_birth_country, c_login, c_email_address, d_year
UNION ALL    SELECT
     c_customer_id customer_id
   , c_first_name customer_first_name
   , c_last_name customer_last_name
   , c_preferred_cust_flag customer_preferred_cust_flag
   , c_birth_country customer_birth_country
   , c_login customer_login
   , c_email_address customer_email_address
   , d_year dyear
   , sum((ws_ext_list_price - ws_ext_discount_amt)) year_total
   , 'w' sale_type
   FROM
     customer
   , web_sales
   , date_dim
   WHERE (c_customer_sk = ws_bill_customer_sk)
      AND (ws_sold_date_sk = d_date_sk)
   GROUP BY c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag, c_birth_country, c_login, c_email_address, d_year
) 
SELECT
  t_s_secyear.customer_id
, t_s_secyear.customer_first_name
, t_s_secyear.customer_last_name
, t_s_secyear.customer_preferred_cust_flag
, t_s_secyear.customer_birth_country
, t_s_secyear.customer_login
FROM
  year_total t_s_firstyear
, year_total t_s_secyear
, year_total t_w_firstyear
, year_total t_w_secyear
WHERE (t_s_secyear.customer_id = t_s_firstyear.customer_id)
   AND (t_s_firstyear.customer_id = t_w_secyear.customer_id)
   AND (t_s_firstyear.customer_id = t_w_firstyear.customer_id)
   AND (t_s_firstyear.sale_type = 's')
   AND (t_w_firstyear.sale_type = 'w')
   AND (t_s_secyear.sale_type = 's')
   AND (t_w_secyear.sale_type = 'w')
   AND (t_s_firstyear.dyear = 2001)
   AND (t_s_secyear.dyear = (2001 + 1))
   AND (t_w_firstyear.dyear = 2001)
   AND (t_w_secyear.dyear = (2001 + 1))
   AND (t_s_firstyear.year_total > 0)
   AND (t_w_firstyear.year_total > 0)
   AND ((CASE WHEN (t_w_firstyear.year_total > 0) THEN (t_w_secyear.year_total / t_w_firstyear.year_total) ELSE DECIMAL '0.0' END) > (CASE WHEN (t_s_firstyear.year_total > 0) THEN (t_s_secyear.year_total / t_s_firstyear.year_total) ELSE DECIMAL '0.0' END))
ORDER BY t_s_secyear.customer_id ASC, t_s_secyear.customer_first_name ASC, t_s_secyear.customer_last_name ASC, t_s_secyear.customer_preferred_cust_flag ASC
LIMIT 100
""",
    17: """
SELECT
  i_item_id
, i_item_desc
, s_state
, count(ss_quantity) store_sales_quantitycount
, avg(ss_quantity) store_sales_quantityave
, stddev_samp(ss_quantity) store_sales_quantitystdev
, (stddev_samp(ss_quantity) / avg(ss_quantity)) store_sales_quantitycov
, count(sr_return_quantity) store_returns_quantitycount
, avg(sr_return_quantity) store_returns_quantityave
, stddev_samp(sr_return_quantity) store_returns_quantitystdev
, (stddev_samp(sr_return_quantity) / avg(sr_return_quantity)) store_returns_quantitycov
, count(cs_quantity) catalog_sales_quantitycount
, avg(cs_quantity) catalog_sales_quantityave
, stddev_samp(cs_quantity) catalog_sales_quantitystdev
, (stddev_samp(cs_quantity) / avg(cs_quantity)) catalog_sales_quantitycov
FROM
  store_sales
, store_returns
, catalog_sales
, date_dim d1
, date_dim d2
, date_dim d3
, store
, item
WHERE (d1.d_quarter_name = '2001Q1')
   AND (d1.d_date_sk = ss_sold_date_sk)
   AND (i_item_sk = ss_item_sk)
   AND (s_store_sk = ss_store_sk)
   AND (ss_customer_sk = sr_customer_sk)
   AND (ss_item_sk = sr_item_sk)
   AND (ss_ticket_number = sr_ticket_number)
   AND (sr_returned_date_sk = d2.d_date_sk)
   AND (d2.d_quarter_name IN ('2001Q1', '2001Q2', '2001Q3'))
   AND (sr_customer_sk = cs_bill_customer_sk)
   AND (sr_item_sk = cs_item_sk)
   AND (cs_sold_date_sk = d3.d_date_sk)
   AND (d3.d_quarter_name IN ('2001Q1', '2001Q2', '2001Q3'))
GROUP BY i_item_id, i_item_desc, s_state
ORDER BY i_item_id ASC, i_item_desc ASC, s_state ASC
LIMIT 100
""",
    23: """
WITH
  frequent_ss_items AS (
   SELECT
     substr(i_item_desc, 1, 30) itemdesc
   , i_item_sk item_sk
   , d_date solddate
   , count(*) cnt
   FROM
     store_sales
   , date_dim
   , item
   WHERE (ss_sold_date_sk = d_date_sk)
      AND (ss_item_sk = i_item_sk)
      AND (d_year IN (2000   , (2000 + 1)   , (2000 + 2)   , (2000 + 3)))
   GROUP BY substr(i_item_desc, 1, 30), i_item_sk, d_date
   HAVING (count(*) > 4)
) 
, max_store_sales AS (
   SELECT max(csales) tpcds_cmax
   FROM
     (
      SELECT
        c_customer_sk
      , sum((ss_quantity * ss_sales_price)) csales
      FROM
        store_sales
      , customer
      , date_dim
      WHERE (ss_customer_sk = c_customer_sk)
         AND (ss_sold_date_sk = d_date_sk)
         AND (d_year IN (2000      , (2000 + 1)      , (2000 + 2)      , (2000 + 3)))
      GROUP BY c_customer_sk
   ) 
) 
, best_ss_customer AS (
   SELECT
     c_customer_sk
   , sum((ss_quantity * ss_sales_price)) ssales
   FROM
     store_sales
   , customer
   WHERE (ss_customer_sk = c_customer_sk)
   GROUP BY c_customer_sk
   HAVING (sum((ss_quantity * ss_sales_price)) > ((50 / DECIMAL '100.0') * (
            SELECT *
            FROM
              max_store_sales
         )))
) 
SELECT sum(sales)
FROM
  (
   SELECT (cs_quantity * cs_list_price) sales
   FROM
     catalog_sales
   , date_dim
   WHERE (d_year = 2000)
      AND (d_moy = 2)
      AND (cs_sold_date_sk = d_date_sk)
      AND (cs_item_sk IN (
      SELECT item_sk
      FROM
        frequent_ss_items
   ))
      AND (cs_bill_customer_sk IN (
      SELECT c_customer_sk
      FROM
        best_ss_customer
   ))
UNION ALL    SELECT (ws_quantity * ws_list_price) sales
   FROM
     web_sales
   , date_dim
   WHERE (d_year = 2000)
      AND (d_moy = 2)
      AND (ws_sold_date_sk = d_date_sk)
      AND (ws_item_sk IN (
      SELECT item_sk
      FROM
        frequent_ss_items
   ))
      AND (ws_bill_customer_sk IN (
      SELECT c_customer_sk
      FROM
        best_ss_customer
   ))
) 
LIMIT 100
""",
    28: """
SELECT *
FROM
  (
   SELECT
     avg(ss_list_price) b1_lp
   , count(ss_list_price) b1_cnt
   , count(DISTINCT ss_list_price) b1_cntd
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 0 AND 5)
      AND ((ss_list_price BETWEEN 8 AND (8 + 10))
         OR (ss_coupon_amt BETWEEN 459 AND (459 + 1000))
         OR (ss_wholesale_cost BETWEEN 57 AND (57 + 20)))
)  b1
, (
   SELECT
     avg(ss_list_price) b2_lp
   , count(ss_list_price) b2_cnt
   , count(DISTINCT ss_list_price) b2_cntd
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 6 AND 10)
      AND ((ss_list_price BETWEEN 90 AND (90 + 10))
         OR (ss_coupon_amt BETWEEN 2323 AND (2323 + 1000))
         OR (ss_wholesale_cost BETWEEN 31 AND (31 + 20)))
)  b2
, (
   SELECT
     avg(ss_list_price) b3_lp
   , count(ss_list_price) b3_cnt
   , count(DISTINCT ss_list_price) b3_cntd
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 11 AND 15)
      AND ((ss_list_price BETWEEN 142 AND (142 + 10))
         OR (ss_coupon_amt BETWEEN 12214 AND (12214 + 1000))
         OR (ss_wholesale_cost BETWEEN 79 AND (79 + 20)))
)  b3
, (
   SELECT
     avg(ss_list_price) b4_lp
   , count(ss_list_price) b4_cnt
   , count(DISTINCT ss_list_price) b4_cntd
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 16 AND 20)
      AND ((ss_list_price BETWEEN 135 AND (135 + 10))
         OR (ss_coupon_amt BETWEEN 6071 AND (6071 + 1000))
         OR (ss_wholesale_cost BETWEEN 38 AND (38 + 20)))
)  b4
, (
   SELECT
     avg(ss_list_price) b5_lp
   , count(ss_list_price) b5_cnt
   , count(DISTINCT ss_list_price) b5_cntd
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 21 AND 25)
      AND ((ss_list_price BETWEEN 122 AND (122 + 10))
         OR (ss_coupon_amt BETWEEN 836 AND (836 + 1000))
         OR (ss_wholesale_cost BETWEEN 17 AND (17 + 20)))
)  b5
, (
   SELECT
     avg(ss_list_price) b6_lp
   , count(ss_list_price) b6_cnt
   , count(DISTINCT ss_list_price) b6_cntd
   FROM
     store_sales
   WHERE (ss_quantity BETWEEN 26 AND 30)
      AND ((ss_list_price BETWEEN 154 AND (154 + 10))
         OR (ss_coupon_amt BETWEEN 7326 AND (7326 + 1000))
         OR (ss_wholesale_cost BETWEEN 7 AND (7 + 20)))
)  b6
LIMIT 100
""",
    38: """
select count(*) from (
    select distinct c_last_name, c_first_name, d_date
    from store_sales, date_dim, customer
    where store_sales.ss_sold_date_sk = date_dim.d_date_sk
      and store_sales.ss_customer_sk = customer.c_customer_sk
      and d_month_seq between 1200 and 1200 + 11
    intersect
    select distinct c_last_name, c_first_name, d_date
    from catalog_sales, date_dim, customer
    where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
      and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
      and d_month_seq between 1200 and 1200 + 11
    intersect
    select distinct c_last_name, c_first_name, d_date
    from web_sales, date_dim, customer
    where web_sales.ws_sold_date_sk = date_dim.d_date_sk
      and web_sales.ws_bill_customer_sk = customer.c_customer_sk
      and d_month_seq between 1200 and 1200 + 11
) hot_cust
limit 100
""",
    87: """
select count(*) from (
    select distinct c_last_name, c_first_name, d_date
    from store_sales, date_dim, customer
    where store_sales.ss_sold_date_sk = date_dim.d_date_sk
      and store_sales.ss_customer_sk = customer.c_customer_sk
      and d_month_seq between 1200 and 1200 + 11
    except
    select distinct c_last_name, c_first_name, d_date
    from catalog_sales, date_dim, customer
    where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
      and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
      and d_month_seq between 1200 and 1200 + 11
    except
    select distinct c_last_name, c_first_name, d_date
    from web_sales, date_dim, customer
    where web_sales.ws_sold_date_sk = date_dim.d_date_sk
      and web_sales.ws_bill_customer_sk = customer.c_customer_sk
      and d_month_seq between 1200 and 1200 + 11
) cool_cust
""",
    8: """
select s_store_name, sum(ss_net_profit) as profit
from store_sales, date_dim, store,
     (select ca_zip
      from (select substr(ca_zip, 1, 5) as ca_zip
            from customer_address
            where substr(ca_zip, 1, 5) in
                  ('47602','16704','35863','28577','83910','36201',
                   '58412','48162','28055','41419','80332','38607',
                   '77817','24891','16226','18410','21231','59345',
                   '13918','51089','20317','17167','54585','67881',
                   '78366','47770','18360','51717','73108','14440')
            intersect
            select ca_zip
            from (select substr(ca_zip, 1, 5) as ca_zip, count(*) as cnt
                  from customer_address, customer
                  where ca_address_sk = c_current_addr_sk
                    and c_preferred_cust_flag = 'Y'
                  group by substr(ca_zip, 1, 5)
                  having count(*) > 1) a1) a2
     ) v1
where ss_store_sk = s_store_sk
  and ss_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 1998
  and substr(s_zip, 1, 2) = substr(v1.ca_zip, 1, 2)
group by s_store_name
order by s_store_name
limit 100
""",
    10: """
select cd_gender, cd_marital_status, cd_education_status,
       count(*) as cnt1, cd_purchase_estimate, count(*) as cnt2,
       cd_credit_rating, count(*) as cnt3, cd_dep_count, count(*) as cnt4,
       cd_dep_employed_count, count(*) as cnt5,
       cd_dep_college_count, count(*) as cnt6
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2000 and d_moy between 1 and 4)
  and (exists (select * from web_sales, date_dim
               where c.c_customer_sk = ws_bill_customer_sk
                 and ws_sold_date_sk = d_date_sk
                 and d_year = 2000 and d_moy between 1 and 4)
       or exists (select * from catalog_sales, date_dim
                  where c.c_customer_sk = cs_ship_customer_sk
                    and cs_sold_date_sk = d_date_sk
                    and d_year = 2000 and d_moy between 1 and 4))
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
limit 100
""",
    16: """
select count(distinct cs_order_number) as order_count,
       sum(cs_ext_ship_cost) as total_shipping_cost,
       sum(cs_net_profit) as total_net_profit
from catalog_sales cs1, date_dim, customer_address, call_center
where d_date between cast('2000-02-01' as date)
                 and cast('2000-02-01' as date) + interval '60' day
  and cs1.cs_ship_date_sk = d_date_sk
  and cs1.cs_ship_addr_sk = ca_address_sk
  and ca_state = 'GA'
  and cs1.cs_call_center_sk = cc_call_center_sk
  and exists (select * from catalog_sales cs2
              where cs1.cs_order_number = cs2.cs_order_number
                and cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk)
  and not exists (select * from catalog_returns cr1
                  where cs1.cs_order_number = cr1.cr_order_number)
order by order_count
limit 100
""",
    24: """
with ssales as (
    select c_last_name, c_first_name, s_store_name, ca_state, s_state,
           i_color, i_current_price, i_manager_id, i_units, i_size,
           sum(ss_net_paid) as netpaid
    from store_sales, store_returns, store, item, customer, customer_address
    where ss_ticket_number = sr_ticket_number
      and ss_item_sk = sr_item_sk
      and ss_customer_sk = c_customer_sk
      and ss_item_sk = i_item_sk
      and ss_store_sk = s_store_sk
      and c_current_addr_sk = ca_address_sk
      and c_birth_country <> upper(ca_country)
      and s_zip = ca_zip
      and s_market_id = 5
    group by c_last_name, c_first_name, s_store_name, ca_state, s_state,
             i_color, i_current_price, i_manager_id, i_units, i_size
)
select c_last_name, c_first_name, s_store_name, sum(netpaid) as paid
from ssales
where i_color = 'aquamarine'
group by c_last_name, c_first_name, s_store_name
having sum(netpaid) > (select 0.05 * avg(netpaid) from ssales)
order by c_last_name, c_first_name, s_store_name
""",
    30: """
with customer_total_return as (
    select wr_returning_customer_sk as ctr_customer_sk,
           ca_state as ctr_state,
           sum(wr_return_amt) as ctr_total_return
    from web_returns, date_dim, customer_address
    where wr_returned_date_sk = d_date_sk
      and d_year = 2000
      and wr_returning_addr_sk = ca_address_sk
    group by wr_returning_customer_sk, ca_state
)
select c_customer_id, c_salutation, c_first_name, c_last_name,
       c_preferred_cust_flag, c_birth_day, c_birth_month, c_birth_year,
       c_birth_country, c_login, c_email_address, c_last_review_date_sk,
       ctr_total_return
from customer_total_return ctr1, customer_address, customer
where ctr1.ctr_total_return > (select avg(ctr_total_return) * 1.2
                               from customer_total_return ctr2
                               where ctr1.ctr_state = ctr2.ctr_state)
  and ca_address_sk = c_current_addr_sk
  and ca_state = 'GA'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, c_salutation, c_first_name, c_last_name,
         c_preferred_cust_flag, c_birth_day, c_birth_month, c_birth_year,
         c_birth_country, c_login, c_email_address, c_last_review_date_sk,
         ctr_total_return
limit 100
""",
    31: """
with ss as (
    select ca_county, d_qoy, d_year, sum(ss_ext_sales_price) as store_sales
    from store_sales, date_dim, customer_address
    where ss_sold_date_sk = d_date_sk and ss_addr_sk = ca_address_sk
    group by ca_county, d_qoy, d_year
), ws as (
    select ca_county, d_qoy, d_year, sum(ws_ext_sales_price) as web_sales
    from web_sales, date_dim, customer_address
    where ws_sold_date_sk = d_date_sk and ws_bill_addr_sk = ca_address_sk
    group by ca_county, d_qoy, d_year
)
select ss1.ca_county, ss1.d_year,
       ws2.web_sales / ws1.web_sales as web_q1_q2_increase,
       ss2.store_sales / ss1.store_sales as store_q1_q2_increase,
       ws3.web_sales / ws2.web_sales as web_q2_q3_increase,
       ss3.store_sales / ss2.store_sales as store_q2_q3_increase
from ss ss1, ss ss2, ss ss3, ws ws1, ws ws2, ws ws3
where ss1.d_qoy = 1 and ss1.d_year = 2000
  and ss1.ca_county = ss2.ca_county
  and ss2.d_qoy = 2 and ss2.d_year = 2000
  and ss2.ca_county = ss3.ca_county
  and ss3.d_qoy = 3 and ss3.d_year = 2000
  and ss1.ca_county = ws1.ca_county
  and ws1.d_qoy = 1 and ws1.d_year = 2000
  and ws1.ca_county = ws2.ca_county
  and ws2.d_qoy = 2 and ws2.d_year = 2000
  and ws1.ca_county = ws3.ca_county
  and ws3.d_qoy = 3 and ws3.d_year = 2000
  and case when ws1.web_sales > 0 then ws2.web_sales / ws1.web_sales else null end
      > case when ss1.store_sales > 0 then ss2.store_sales / ss1.store_sales else null end
  and case when ws2.web_sales > 0 then ws3.web_sales / ws2.web_sales else null end
      > case when ss2.store_sales > 0 then ss3.store_sales / ss2.store_sales else null end
order by ss1.ca_county
""",
    32: """
select sum(cs_ext_discount_amt) as excess_discount_amount
from catalog_sales, item, date_dim
where i_manufact_id = 66
  and i_item_sk = cs_item_sk
  and d_date between cast('2000-01-27' as date)
                 and cast('2000-01-27' as date) + interval '90' day
  and d_date_sk = cs_sold_date_sk
  and cs_ext_discount_amt > (
        select 1.3 * avg(cs_ext_discount_amt)
        from catalog_sales, date_dim
        where cs_item_sk = i_item_sk
          and d_date between cast('2000-01-27' as date)
                         and cast('2000-01-27' as date) + interval '90' day
          and d_date_sk = cs_sold_date_sk)
limit 100
""",
    33: """
with ss as (
    select i_manufact_id, sum(ss_ext_sales_price) as total_sales
    from store_sales, date_dim, customer_address, item
    where i_manufact_id in (select i_manufact_id from item
                            where i_category in ('Electronics'))
      and ss_item_sk = i_item_sk
      and ss_sold_date_sk = d_date_sk
      and d_year = 1998 and d_moy = 5
      and ss_addr_sk = ca_address_sk
      and ca_gmt_offset = -5
    group by i_manufact_id
), cs as (
    select i_manufact_id, sum(cs_ext_sales_price) as total_sales
    from catalog_sales, date_dim, customer_address, item
    where i_manufact_id in (select i_manufact_id from item
                            where i_category in ('Electronics'))
      and cs_item_sk = i_item_sk
      and cs_sold_date_sk = d_date_sk
      and d_year = 1998 and d_moy = 5
      and cs_bill_addr_sk = ca_address_sk
      and ca_gmt_offset = -5
    group by i_manufact_id
), ws as (
    select i_manufact_id, sum(ws_ext_sales_price) as total_sales
    from web_sales, date_dim, customer_address, item
    where i_manufact_id in (select i_manufact_id from item
                            where i_category in ('Electronics'))
      and ws_item_sk = i_item_sk
      and ws_sold_date_sk = d_date_sk
      and d_year = 1998 and d_moy = 5
      and ws_bill_addr_sk = ca_address_sk
      and ca_gmt_offset = -5
    group by i_manufact_id
)
select i_manufact_id, sum(total_sales) as total_sales
from (select * from ss union all select * from cs union all select * from ws) tmp1
group by i_manufact_id
order by total_sales, i_manufact_id
limit 100
""",
    34: """
select c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) as cnt
      from store_sales, date_dim, store, household_demographics
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_store_sk = store.s_store_sk
        and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        and (date_dim.d_dom between 1 and 3 or date_dim.d_dom between 25 and 28)
        and (household_demographics.hd_buy_potential = '>10000'
             or household_demographics.hd_buy_potential = 'Unknown')
        and household_demographics.hd_vehicle_count > 0
        and (case when household_demographics.hd_vehicle_count > 0
                  then household_demographics.hd_dep_count
                       / household_demographics.hd_vehicle_count
                  else null end) > 1.2
        and date_dim.d_year in (1998, 1999, 2000)
        and store.s_county in ('Ziebach County', 'Barrow County',
                               'Walker County', 'Richland County')
      group by ss_ticket_number, ss_customer_sk) dn, customer
where ss_customer_sk = c_customer_sk
  and cnt between 15 and 20
order by c_last_name, c_first_name, c_salutation,
         c_preferred_cust_flag desc, ss_ticket_number
""",
    35: """
select ca_state, cd_gender, cd_marital_status, cd_dep_count,
       count(*) as cnt1, min(cd_dep_count) as min1, max(cd_dep_count) as max1,
       avg(cd_dep_count) as avg1, cd_dep_employed_count,
       count(*) as cnt2, min(cd_dep_employed_count) as min2,
       max(cd_dep_employed_count) as max2, avg(cd_dep_employed_count) as avg2,
       cd_dep_college_count, count(*) as cnt3,
       min(cd_dep_college_count) as min3, max(cd_dep_college_count) as max3,
       avg(cd_dep_college_count) as avg3
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2000 and d_qoy < 4)
  and (exists (select * from web_sales, date_dim
               where c.c_customer_sk = ws_bill_customer_sk
                 and ws_sold_date_sk = d_date_sk
                 and d_year = 2000 and d_qoy < 4)
       or exists (select * from catalog_sales, date_dim
                  where c.c_customer_sk = cs_ship_customer_sk
                    and cs_sold_date_sk = d_date_sk
                    and d_year = 2000 and d_qoy < 4))
group by ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
order by ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
limit 100
""",
    39: """
with inv as (
    select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy, stdev, mean,
           case mean when 0 then null else stdev / mean end as cov
    from (select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy,
                 stddev_samp(inv_quantity_on_hand) as stdev,
                 avg(inv_quantity_on_hand) as mean
          from inventory, item, warehouse, date_dim
          where inv_item_sk = i_item_sk
            and inv_warehouse_sk = w_warehouse_sk
            and inv_date_sk = d_date_sk
            and d_year = 1999
          group by w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy) foo
    where case mean when 0 then 0 else stdev / mean end > 1
)
select inv1.w_warehouse_sk as wsk1, inv1.i_item_sk as isk1,
       inv1.d_moy as moy1, inv1.mean as mean1, inv1.cov as cov1,
       inv2.w_warehouse_sk as wsk2, inv2.i_item_sk as isk2,
       inv2.d_moy as moy2, inv2.mean as mean2, inv2.cov as cov2
from inv inv1, inv inv2
where inv1.i_item_sk = inv2.i_item_sk
  and inv1.w_warehouse_sk = inv2.w_warehouse_sk
  and inv1.d_moy = 1
  and inv2.d_moy = 2
order by wsk1, isk1, moy1, mean1, cov1
""",
    40: """
select w_state, i_item_id,
       sum(case when cast(d_date as date) < cast('2000-03-11' as date)
                then cs_sales_price - coalesce(cr_refunded_cash, 0)
                else 0 end) as sales_before,
       sum(case when cast(d_date as date) >= cast('2000-03-11' as date)
                then cs_sales_price - coalesce(cr_refunded_cash, 0)
                else 0 end) as sales_after
from catalog_sales
left outer join catalog_returns
  on (cs_order_number = cr_order_number and cs_item_sk = cr_item_sk),
warehouse, item, date_dim
where i_current_price between 0.99 and 1.49
  and i_item_sk = cs_item_sk
  and cs_warehouse_sk = w_warehouse_sk
  and cs_sold_date_sk = d_date_sk
  and d_date between cast('2000-03-11' as date) - interval '30' day
                 and cast('2000-03-11' as date) + interval '30' day
group by w_state, i_item_id
order by w_state, i_item_id
limit 100
""",
    41: """
select distinct i_product_name
from item i1
where i_manufact_id between 70 and 70 + 40
  and (select count(*) as item_cnt
       from item
       where (i_manufact = i1.i_manufact
              and ((i_category = 'Women' and i_color in ('powder', 'khaki')
                    and i_units in ('Ounce', 'Oz') and i_size in ('medium', 'economy'))
                   or (i_category = 'Women' and i_color in ('brown', 'honeydew')
                       and i_units in ('Bunch', 'Ton') and i_size in ('N/A', 'small'))
                   or (i_category = 'Men' and i_color in ('floral', 'deep')
                       and i_units in ('N/A', 'Dozen') and i_size in ('petite', 'petite'))
                   or (i_category = 'Men' and i_color in ('light', 'cornflower')
                       and i_units in ('Box', 'Pound') and i_size in ('medium', 'economy'))))
          or (i_manufact = i1.i_manufact
              and ((i_category = 'Women' and i_color in ('midnight', 'snow')
                    and i_units in ('Pallet', 'Gross') and i_size in ('medium', 'economy'))
                   or (i_category = 'Women' and i_color in ('cyan', 'papaya')
                       and i_units in ('Cup', 'Dram') and i_size in ('N/A', 'small'))
                   or (i_category = 'Men' and i_color in ('orange', 'frosted')
                       and i_units in ('Each', 'Tbl') and i_size in ('petite', 'petite'))
                   or (i_category = 'Men' and i_color in ('forest', 'ghost')
                       and i_units in ('Lb', 'Bundle') and i_size in ('medium', 'economy'))))) > 0
order by i_product_name
limit 100
""",
    44: """
select asceding.rnk as rnk, i1.i_product_name as best_performing,
       i2.i_product_name as worst_performing
from (select *
      from (select item_sk, rank() over (order by rank_col asc) as rnk
            from (select ss_item_sk as item_sk, avg(ss_net_profit) as rank_col
                  from store_sales ss1
                  where ss_store_sk = 4
                  group by ss_item_sk
                  having avg(ss_net_profit) > 0.9 * (
                        select avg(ss_net_profit) as rank_col
                        from store_sales
                        where ss_store_sk = 4
                          and ss_addr_sk is null)) v1) v11
      where rnk < 11) asceding,
     (select *
      from (select item_sk, rank() over (order by rank_col desc) as rnk
            from (select ss_item_sk as item_sk, avg(ss_net_profit) as rank_col
                  from store_sales ss1
                  where ss_store_sk = 4
                  group by ss_item_sk
                  having avg(ss_net_profit) > 0.9 * (
                        select avg(ss_net_profit) as rank_col
                        from store_sales
                        where ss_store_sk = 4
                          and ss_addr_sk is null)) v2) v21
      where rnk < 11) descending,
     item i1, item i2
where asceding.rnk = descending.rnk
  and i1.i_item_sk = asceding.item_sk
  and i2.i_item_sk = descending.item_sk
order by asceding.rnk
limit 100
""",
    45: """
select ca_zip, ca_city, sum(ws_sales_price) as total_sales
from web_sales, customer, customer_address, date_dim, item
where ws_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ws_item_sk = i_item_sk
  and (substr(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405',
                                '86475', '85392', '85460', '80348', '81792')
       or i_item_id in (select i_item_id from item
                        where i_item_sk in (2, 3, 5, 7, 11, 13, 17, 19, 23)))
  and ws_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 2000
group by ca_zip, ca_city
order by ca_zip, ca_city
limit 100
""",
    47: """
with v1 as (
    select i_category, i_brand, s_store_name, s_company_name,
           d_year, d_moy, sum(ss_sales_price) as sum_sales,
           avg(sum(ss_sales_price)) over (
               partition by i_category, i_brand, s_store_name, s_company_name, d_year
           ) as avg_monthly_sales,
           rank() over (
               partition by i_category, i_brand, s_store_name, s_company_name
               order by d_year, d_moy
           ) as rn
    from item, store_sales, date_dim, store
    where ss_item_sk = i_item_sk
      and ss_sold_date_sk = d_date_sk
      and ss_store_sk = s_store_sk
      and (d_year = 1999
           or (d_year = 1998 and d_moy = 12)
           or (d_year = 2000 and d_moy = 1))
    group by i_category, i_brand, s_store_name, s_company_name, d_year, d_moy
), v2 as (
    select v1.i_category, v1.i_brand, v1.s_store_name, v1.s_company_name,
           v1.d_year, v1.d_moy, v1.avg_monthly_sales, v1.sum_sales,
           v1_lag.sum_sales as psum, v1_lead.sum_sales as nsum
    from v1, v1 v1_lag, v1 v1_lead
    where v1.i_category = v1_lag.i_category
      and v1.i_category = v1_lead.i_category
      and v1.i_brand = v1_lag.i_brand
      and v1.i_brand = v1_lead.i_brand
      and v1.s_store_name = v1_lag.s_store_name
      and v1.s_store_name = v1_lead.s_store_name
      and v1.s_company_name = v1_lag.s_company_name
      and v1.s_company_name = v1_lead.s_company_name
      and v1.rn = v1_lag.rn + 1
      and v1.rn = v1_lead.rn - 1
)
select * from v2
where d_year = 1999
  and avg_monthly_sales > 0
  and case when avg_monthly_sales > 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else null end > 0.1
order by sum_sales - avg_monthly_sales, s_store_name
limit 100
""",
    49: """
select channel, item, return_ratio, return_rank, currency_rank
from (select 'web' as channel, web.item, web.return_ratio,
             web.return_rank, web.currency_rank
      from (select item, return_ratio, currency_ratio,
                   rank() over (order by return_ratio) as return_rank,
                   rank() over (order by currency_ratio) as currency_rank
            from (select ws.ws_item_sk as item,
                         cast(sum(coalesce(wr.wr_return_quantity, 0)) as double)
                         / cast(sum(coalesce(ws.ws_quantity, 0)) as double) as return_ratio,
                         cast(sum(coalesce(wr.wr_return_amt, 0)) as double)
                         / cast(sum(coalesce(ws.ws_net_paid, 0)) as double) as currency_ratio
                  from web_sales ws
                  left outer join web_returns wr
                    on (ws.ws_order_number = wr.wr_order_number
                        and ws.ws_item_sk = wr.wr_item_sk),
                  date_dim
                  where wr.wr_return_amt > 100
                    and ws.ws_net_profit > 1
                    and ws.ws_net_paid > 0
                    and ws.ws_quantity > 0
                    and ws_sold_date_sk = d_date_sk
                    and d_year = 2000 and d_moy = 12
                  group by ws.ws_item_sk) in_web) web
      where web.return_rank <= 10 or web.currency_rank <= 10
      union all
      select 'catalog' as channel, catalog.item, catalog.return_ratio,
             catalog.return_rank, catalog.currency_rank
      from (select item, return_ratio, currency_ratio,
                   rank() over (order by return_ratio) as return_rank,
                   rank() over (order by currency_ratio) as currency_rank
            from (select cs.cs_item_sk as item,
                         cast(sum(coalesce(cr.cr_return_quantity, 0)) as double)
                         / cast(sum(coalesce(cs.cs_quantity, 0)) as double) as return_ratio,
                         cast(sum(coalesce(cr.cr_return_amount, 0)) as double)
                         / cast(sum(coalesce(cs.cs_net_paid, 0)) as double) as currency_ratio
                  from catalog_sales cs
                  left outer join catalog_returns cr
                    on (cs.cs_order_number = cr.cr_order_number
                        and cs.cs_item_sk = cr.cr_item_sk),
                  date_dim
                  where cr.cr_return_amount > 100
                    and cs.cs_net_profit > 1
                    and cs.cs_net_paid > 0
                    and cs.cs_quantity > 0
                    and cs_sold_date_sk = d_date_sk
                    and d_year = 2000 and d_moy = 12
                  group by cs.cs_item_sk) in_cat) catalog
      where catalog.return_rank <= 10 or catalog.currency_rank <= 10
      union all
      select 'store' as channel, store.item, store.return_ratio,
             store.return_rank, store.currency_rank
      from (select item, return_ratio, currency_ratio,
                   rank() over (order by return_ratio) as return_rank,
                   rank() over (order by currency_ratio) as currency_rank
            from (select sts.ss_item_sk as item,
                         cast(sum(coalesce(sr.sr_return_quantity, 0)) as double)
                         / cast(sum(coalesce(sts.ss_quantity, 0)) as double) as return_ratio,
                         cast(sum(coalesce(sr.sr_return_amt, 0)) as double)
                         / cast(sum(coalesce(sts.ss_net_paid, 0)) as double) as currency_ratio
                  from store_sales sts
                  left outer join store_returns sr
                    on (sts.ss_ticket_number = sr.sr_ticket_number
                        and sts.ss_item_sk = sr.sr_item_sk),
                  date_dim
                  where sr.sr_return_amt > 100
                    and sts.ss_net_profit > 1
                    and sts.ss_net_paid > 0
                    and sts.ss_quantity > 0
                    and ss_sold_date_sk = d_date_sk
                    and d_year = 2000 and d_moy = 12
                  group by sts.ss_item_sk) in_store) store
      where store.return_rank <= 10 or store.currency_rank <= 10) sq1
order by 1, 4, 5, 2
limit 100
""",
    51: """
with web_v1 as (
    select ws_item_sk as item_sk, d_date,
           sum(sum(ws_sales_price)) over (
               partition by ws_item_sk order by d_date
               rows between unbounded preceding and current row
           ) as cume_sales
    from web_sales, date_dim
    where ws_sold_date_sk = d_date_sk
      and d_month_seq between 1200 and 1200 + 11
      and ws_item_sk is not null
    group by ws_item_sk, d_date
), store_v1 as (
    select ss_item_sk as item_sk, d_date,
           sum(sum(ss_sales_price)) over (
               partition by ss_item_sk order by d_date
               rows between unbounded preceding and current row
           ) as cume_sales
    from store_sales, date_dim
    where ss_sold_date_sk = d_date_sk
      and d_month_seq between 1200 and 1200 + 11
      and ss_item_sk is not null
    group by ss_item_sk, d_date
)
select *
from (select item_sk, d_date, web_sales, store_sales,
             max(web_sales) over (
                 partition by item_sk order by d_date
                 rows between unbounded preceding and current row
             ) as web_cumulative,
             max(store_sales) over (
                 partition by item_sk order by d_date
                 rows between unbounded preceding and current row
             ) as store_cumulative
      from (select case when web.item_sk is not null then web.item_sk
                        else store.item_sk end as item_sk,
                   case when web.d_date is not null then web.d_date
                        else store.d_date end as d_date,
                   web.cume_sales as web_sales,
                   store.cume_sales as store_sales
            from web_v1 web
            full outer join store_v1 store
              on (web.item_sk = store.item_sk and web.d_date = store.d_date)) x) y
where web_cumulative > store_cumulative
order by item_sk, d_date
limit 100
""",
    54: """
with my_customers as (
    select distinct c_customer_sk, c_current_addr_sk
    from (select cs_sold_date_sk as sold_date_sk,
                 cs_bill_customer_sk as customer_sk,
                 cs_item_sk as item_sk
          from catalog_sales
          union all
          select ws_sold_date_sk as sold_date_sk,
                 ws_bill_customer_sk as customer_sk,
                 ws_item_sk as item_sk
          from web_sales) cs_or_ws_sales,
         item, date_dim, customer
    where sold_date_sk = d_date_sk
      and item_sk = i_item_sk
      and i_category = 'Women'
      and i_class = 'maternity'
      and c_customer_sk = cs_or_ws_sales.customer_sk
      and d_moy = 5 and d_year = 1998
), my_revenue as (
    select c_customer_sk, sum(ss_ext_sales_price) as revenue
    from my_customers, store_sales, customer_address, store, date_dim
    where c_current_addr_sk = ca_address_sk
      and ca_county = s_county
      and ca_state = s_state
      and ss_sold_date_sk = d_date_sk
      and c_customer_sk = ss_customer_sk
      and d_month_seq between (select distinct d_month_seq + 1 from date_dim
                               where d_year = 1998 and d_moy = 5)
                          and (select distinct d_month_seq + 3 from date_dim
                               where d_year = 1998 and d_moy = 5)
    group by c_customer_sk
), segments as (
    select cast((revenue / 50) as bigint) as segment from my_revenue
)
select segment, count(*) as num_customers, segment * 50 as segment_base
from segments
group by segment
order by segment, num_customers
limit 100
""",
    56: """
with ss as (
    select i_item_id, sum(ss_ext_sales_price) as total_sales
    from store_sales, date_dim, customer_address, item
    where i_item_id in (select i_item_id from item
                        where i_color in ('slate', 'blanched', 'burnished'))
      and ss_item_sk = i_item_sk
      and ss_sold_date_sk = d_date_sk
      and d_year = 2001 and d_moy = 2
      and ss_addr_sk = ca_address_sk
      and ca_gmt_offset = -5
    group by i_item_id
), cs as (
    select i_item_id, sum(cs_ext_sales_price) as total_sales
    from catalog_sales, date_dim, customer_address, item
    where i_item_id in (select i_item_id from item
                        where i_color in ('slate', 'blanched', 'burnished'))
      and cs_item_sk = i_item_sk
      and cs_sold_date_sk = d_date_sk
      and d_year = 2001 and d_moy = 2
      and cs_bill_addr_sk = ca_address_sk
      and ca_gmt_offset = -5
    group by i_item_id
), ws as (
    select i_item_id, sum(ws_ext_sales_price) as total_sales
    from web_sales, date_dim, customer_address, item
    where i_item_id in (select i_item_id from item
                        where i_color in ('slate', 'blanched', 'burnished'))
      and ws_item_sk = i_item_sk
      and ws_sold_date_sk = d_date_sk
      and d_year = 2001 and d_moy = 2
      and ws_bill_addr_sk = ca_address_sk
      and ca_gmt_offset = -5
    group by i_item_id
)
select i_item_id, sum(total_sales) as total_sales
from (select * from ss union all select * from cs union all select * from ws) tmp1
group by i_item_id
order by total_sales, i_item_id
limit 100
""",
    57: """
with v1 as (
    select i_category, i_brand, cc_name, d_year, d_moy,
           sum(cs_sales_price) as sum_sales,
           avg(sum(cs_sales_price)) over (
               partition by i_category, i_brand, cc_name, d_year
           ) as avg_monthly_sales,
           rank() over (
               partition by i_category, i_brand, cc_name
               order by d_year, d_moy
           ) as rn
    from item, catalog_sales, date_dim, call_center
    where cs_item_sk = i_item_sk
      and cs_sold_date_sk = d_date_sk
      and cc_call_center_sk = cs_call_center_sk
      and (d_year = 1999
           or (d_year = 1998 and d_moy = 12)
           or (d_year = 2000 and d_moy = 1))
    group by i_category, i_brand, cc_name, d_year, d_moy
), v2 as (
    select v1.i_category, v1.i_brand, v1.cc_name, v1.d_year, v1.d_moy,
           v1.avg_monthly_sales, v1.sum_sales,
           v1_lag.sum_sales as psum, v1_lead.sum_sales as nsum
    from v1, v1 v1_lag, v1 v1_lead
    where v1.i_category = v1_lag.i_category
      and v1.i_category = v1_lead.i_category
      and v1.i_brand = v1_lag.i_brand
      and v1.i_brand = v1_lead.i_brand
      and v1.cc_name = v1_lag.cc_name
      and v1.cc_name = v1_lead.cc_name
      and v1.rn = v1_lag.rn + 1
      and v1.rn = v1_lead.rn - 1
)
select * from v2
where d_year = 1999
  and avg_monthly_sales > 0
  and case when avg_monthly_sales > 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else null end > 0.1
order by sum_sales - avg_monthly_sales, cc_name
limit 100
""",
    58: """
with ss_items as (
    select i_item_id as item_id, sum(ss_ext_sales_price) as ss_item_rev
    from store_sales, item, date_dim
    where ss_item_sk = i_item_sk
      and d_date in (select d_date from date_dim
                     where d_week_seq = (select d_week_seq from date_dim
                                         where d_date = cast('2000-03-16' as date)))
      and ss_sold_date_sk = d_date_sk
    group by i_item_id
), cs_items as (
    select i_item_id as item_id, sum(cs_ext_sales_price) as cs_item_rev
    from catalog_sales, item, date_dim
    where cs_item_sk = i_item_sk
      and d_date in (select d_date from date_dim
                     where d_week_seq = (select d_week_seq from date_dim
                                         where d_date = cast('2000-03-16' as date)))
      and cs_sold_date_sk = d_date_sk
    group by i_item_id
), ws_items as (
    select i_item_id as item_id, sum(ws_ext_sales_price) as ws_item_rev
    from web_sales, item, date_dim
    where ws_item_sk = i_item_sk
      and d_date in (select d_date from date_dim
                     where d_week_seq = (select d_week_seq from date_dim
                                         where d_date = cast('2000-03-16' as date)))
      and ws_sold_date_sk = d_date_sk
    group by i_item_id
)
select ss_items.item_id,
       ss_item_rev,
       ss_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100 as ss_dev,
       cs_item_rev,
       cs_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100 as cs_dev,
       ws_item_rev,
       ws_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100 as ws_dev,
       (ss_item_rev + cs_item_rev + ws_item_rev) / 3 as average
from ss_items, cs_items, ws_items
where ss_items.item_id = cs_items.item_id
  and ss_items.item_id = ws_items.item_id
  and ss_item_rev between 0.9 * cs_item_rev and 1.1 * cs_item_rev
  and ss_item_rev between 0.9 * ws_item_rev and 1.1 * ws_item_rev
  and cs_item_rev between 0.9 * ss_item_rev and 1.1 * ss_item_rev
  and cs_item_rev between 0.9 * ws_item_rev and 1.1 * ws_item_rev
  and ws_item_rev between 0.9 * ss_item_rev and 1.1 * ss_item_rev
  and ws_item_rev between 0.9 * cs_item_rev and 1.1 * cs_item_rev
order by ss_items.item_id, ss_item_rev
limit 100
""",
    60: """
with ss as (
    select i_item_id, sum(ss_ext_sales_price) as total_sales
    from store_sales, date_dim, customer_address, item
    where i_item_id in (select i_item_id from item where i_category = 'Music')
      and ss_item_sk = i_item_sk
      and ss_sold_date_sk = d_date_sk
      and d_year = 1998 and d_moy = 9
      and ss_addr_sk = ca_address_sk
      and ca_gmt_offset = -5
    group by i_item_id
), cs as (
    select i_item_id, sum(cs_ext_sales_price) as total_sales
    from catalog_sales, date_dim, customer_address, item
    where i_item_id in (select i_item_id from item where i_category = 'Music')
      and cs_item_sk = i_item_sk
      and cs_sold_date_sk = d_date_sk
      and d_year = 1998 and d_moy = 9
      and cs_bill_addr_sk = ca_address_sk
      and ca_gmt_offset = -5
    group by i_item_id
), ws as (
    select i_item_id, sum(ws_ext_sales_price) as total_sales
    from web_sales, date_dim, customer_address, item
    where i_item_id in (select i_item_id from item where i_category = 'Music')
      and ws_item_sk = i_item_sk
      and ws_sold_date_sk = d_date_sk
      and d_year = 1998 and d_moy = 9
      and ws_bill_addr_sk = ca_address_sk
      and ca_gmt_offset = -5
    group by i_item_id
)
select i_item_id, sum(total_sales) as total_sales
from (select * from ss union all select * from cs union all select * from ws) tmp1
group by i_item_id
order by i_item_id, total_sales
limit 100
""",
    61: """
select promotions, total, cast(promotions as double) / cast(total as double) * 100 as ratio
from (select sum(ss_ext_sales_price) as promotions
      from store_sales, store, promotion, date_dim, customer,
           customer_address, item
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_promo_sk = p_promo_sk
        and ss_customer_sk = c_customer_sk
        and ca_address_sk = c_current_addr_sk
        and ss_item_sk = i_item_sk
        and ca_gmt_offset = -5
        and i_category = 'Jewelry'
        and (p_channel_dmail = 'Y' or p_channel_email = 'Y'
             or p_channel_tv = 'Y')
        and s_gmt_offset = -5
        and d_year = 1998
        and d_moy = 11) promotional_sales,
     (select sum(ss_ext_sales_price) as total
      from store_sales, store, date_dim, customer, customer_address, item
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_customer_sk = c_customer_sk
        and ca_address_sk = c_current_addr_sk
        and ss_item_sk = i_item_sk
        and ca_gmt_offset = -5
        and i_category = 'Jewelry'
        and s_gmt_offset = -5
        and d_year = 1998
        and d_moy = 11) all_sales
order by promotions, total
limit 100
""",
    66: """
select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
       w_country, ship_carriers, year_,
       sum(jan_sales) as jan_sales, sum(feb_sales) as feb_sales,
       sum(mar_sales) as mar_sales, sum(apr_sales) as apr_sales,
       sum(may_sales) as may_sales, sum(jun_sales) as jun_sales,
       sum(jul_sales) as jul_sales, sum(aug_sales) as aug_sales,
       sum(sep_sales) as sep_sales, sum(oct_sales) as oct_sales,
       sum(nov_sales) as nov_sales, sum(dec_sales) as dec_sales,
       sum(jan_net) as jan_net, sum(feb_net) as feb_net,
       sum(mar_net) as mar_net, sum(apr_net) as apr_net,
       sum(may_net) as may_net, sum(jun_net) as jun_net,
       sum(jul_net) as jul_net, sum(aug_net) as aug_net,
       sum(sep_net) as sep_net, sum(oct_net) as oct_net,
       sum(nov_net) as nov_net, sum(dec_net) as dec_net
from (
    select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
           w_country,
           'DHL' || ',' || 'BARIAN' as ship_carriers,
           d_year as year_,
           sum(case when d_moy = 1 then ws_ext_sales_price * ws_quantity else 0 end) as jan_sales,
           sum(case when d_moy = 2 then ws_ext_sales_price * ws_quantity else 0 end) as feb_sales,
           sum(case when d_moy = 3 then ws_ext_sales_price * ws_quantity else 0 end) as mar_sales,
           sum(case when d_moy = 4 then ws_ext_sales_price * ws_quantity else 0 end) as apr_sales,
           sum(case when d_moy = 5 then ws_ext_sales_price * ws_quantity else 0 end) as may_sales,
           sum(case when d_moy = 6 then ws_ext_sales_price * ws_quantity else 0 end) as jun_sales,
           sum(case when d_moy = 7 then ws_ext_sales_price * ws_quantity else 0 end) as jul_sales,
           sum(case when d_moy = 8 then ws_ext_sales_price * ws_quantity else 0 end) as aug_sales,
           sum(case when d_moy = 9 then ws_ext_sales_price * ws_quantity else 0 end) as sep_sales,
           sum(case when d_moy = 10 then ws_ext_sales_price * ws_quantity else 0 end) as oct_sales,
           sum(case when d_moy = 11 then ws_ext_sales_price * ws_quantity else 0 end) as nov_sales,
           sum(case when d_moy = 12 then ws_ext_sales_price * ws_quantity else 0 end) as dec_sales,
           sum(case when d_moy = 1 then ws_net_paid * ws_quantity else 0 end) as jan_net,
           sum(case when d_moy = 2 then ws_net_paid * ws_quantity else 0 end) as feb_net,
           sum(case when d_moy = 3 then ws_net_paid * ws_quantity else 0 end) as mar_net,
           sum(case when d_moy = 4 then ws_net_paid * ws_quantity else 0 end) as apr_net,
           sum(case when d_moy = 5 then ws_net_paid * ws_quantity else 0 end) as may_net,
           sum(case when d_moy = 6 then ws_net_paid * ws_quantity else 0 end) as jun_net,
           sum(case when d_moy = 7 then ws_net_paid * ws_quantity else 0 end) as jul_net,
           sum(case when d_moy = 8 then ws_net_paid * ws_quantity else 0 end) as aug_net,
           sum(case when d_moy = 9 then ws_net_paid * ws_quantity else 0 end) as sep_net,
           sum(case when d_moy = 10 then ws_net_paid * ws_quantity else 0 end) as oct_net,
           sum(case when d_moy = 11 then ws_net_paid * ws_quantity else 0 end) as nov_net,
           sum(case when d_moy = 12 then ws_net_paid * ws_quantity else 0 end) as dec_net
    from web_sales, warehouse, date_dim, time_dim, ship_mode
    where ws_warehouse_sk = w_warehouse_sk
      and ws_sold_date_sk = d_date_sk
      and ws_sold_time_sk = t_time_sk
      and ws_ship_mode_sk = sm_ship_mode_sk
      and d_year = 2001
      and t_time between 30838 and 30838 + 28800
      and sm_carrier in ('DHL', 'BARIAN')
    group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
             w_state, w_country, d_year
    union all
    select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
           w_country,
           'DHL' || ',' || 'BARIAN' as ship_carriers,
           d_year as year_,
           sum(case when d_moy = 1 then cs_sales_price * cs_quantity else 0 end) as jan_sales,
           sum(case when d_moy = 2 then cs_sales_price * cs_quantity else 0 end) as feb_sales,
           sum(case when d_moy = 3 then cs_sales_price * cs_quantity else 0 end) as mar_sales,
           sum(case when d_moy = 4 then cs_sales_price * cs_quantity else 0 end) as apr_sales,
           sum(case when d_moy = 5 then cs_sales_price * cs_quantity else 0 end) as may_sales,
           sum(case when d_moy = 6 then cs_sales_price * cs_quantity else 0 end) as jun_sales,
           sum(case when d_moy = 7 then cs_sales_price * cs_quantity else 0 end) as jul_sales,
           sum(case when d_moy = 8 then cs_sales_price * cs_quantity else 0 end) as aug_sales,
           sum(case when d_moy = 9 then cs_sales_price * cs_quantity else 0 end) as sep_sales,
           sum(case when d_moy = 10 then cs_sales_price * cs_quantity else 0 end) as oct_sales,
           sum(case when d_moy = 11 then cs_sales_price * cs_quantity else 0 end) as nov_sales,
           sum(case when d_moy = 12 then cs_sales_price * cs_quantity else 0 end) as dec_sales,
           sum(case when d_moy = 1 then cs_net_paid_inc_tax * cs_quantity else 0 end) as jan_net,
           sum(case when d_moy = 2 then cs_net_paid_inc_tax * cs_quantity else 0 end) as feb_net,
           sum(case when d_moy = 3 then cs_net_paid_inc_tax * cs_quantity else 0 end) as mar_net,
           sum(case when d_moy = 4 then cs_net_paid_inc_tax * cs_quantity else 0 end) as apr_net,
           sum(case when d_moy = 5 then cs_net_paid_inc_tax * cs_quantity else 0 end) as may_net,
           sum(case when d_moy = 6 then cs_net_paid_inc_tax * cs_quantity else 0 end) as jun_net,
           sum(case when d_moy = 7 then cs_net_paid_inc_tax * cs_quantity else 0 end) as jul_net,
           sum(case when d_moy = 8 then cs_net_paid_inc_tax * cs_quantity else 0 end) as aug_net,
           sum(case when d_moy = 9 then cs_net_paid_inc_tax * cs_quantity else 0 end) as sep_net,
           sum(case when d_moy = 10 then cs_net_paid_inc_tax * cs_quantity else 0 end) as oct_net,
           sum(case when d_moy = 11 then cs_net_paid_inc_tax * cs_quantity else 0 end) as nov_net,
           sum(case when d_moy = 12 then cs_net_paid_inc_tax * cs_quantity else 0 end) as dec_net
    from catalog_sales, warehouse, date_dim, time_dim, ship_mode
    where cs_warehouse_sk = w_warehouse_sk
      and cs_sold_date_sk = d_date_sk
      and cs_sold_time_sk = t_time_sk
      and cs_ship_mode_sk = sm_ship_mode_sk
      and d_year = 2001
      and t_time between 30838 and 30838 + 28800
      and sm_carrier in ('DHL', 'BARIAN')
    group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
             w_state, w_country, d_year
) x
group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
         w_country, ship_carriers, year_
order by w_warehouse_name
limit 100
""",
    5: """
with ssr as (
    select s_store_id,
           sum(sales_price) as sales,
           sum(profit) as profit,
           sum(return_amt) as returns_,
           sum(net_loss) as profit_loss
    from (select ss_store_sk as store_sk,
                 ss_sold_date_sk as date_sk,
                 ss_ext_sales_price as sales_price,
                 ss_net_profit as profit,
                 cast(0 as double) as return_amt,
                 cast(0 as double) as net_loss
          from store_sales
          union all
          select sr_store_sk as store_sk,
                 sr_returned_date_sk as date_sk,
                 cast(0 as double) as sales_price,
                 cast(0 as double) as profit,
                 sr_return_amt as return_amt,
                 sr_net_loss as net_loss
          from store_returns) salesreturns,
         date_dim, store
    where date_sk = d_date_sk
      and d_date between cast('2000-08-23' as date)
                     and cast('2000-08-23' as date) + interval '14' day
      and store_sk = s_store_sk
    group by s_store_id
), csr as (
    select cp_catalog_page_id,
           sum(sales_price) as sales,
           sum(profit) as profit,
           sum(return_amt) as returns_,
           sum(net_loss) as profit_loss
    from (select cs_catalog_page_sk as page_sk,
                 cs_sold_date_sk as date_sk,
                 cs_ext_sales_price as sales_price,
                 cs_net_profit as profit,
                 cast(0 as double) as return_amt,
                 cast(0 as double) as net_loss
          from catalog_sales
          union all
          select cr_catalog_page_sk as page_sk,
                 cr_returned_date_sk as date_sk,
                 cast(0 as double) as sales_price,
                 cast(0 as double) as profit,
                 cr_return_amount as return_amt,
                 cr_net_loss as net_loss
          from catalog_returns) salesreturns,
         date_dim, catalog_page
    where date_sk = d_date_sk
      and d_date between cast('2000-08-23' as date)
                     and cast('2000-08-23' as date) + interval '14' day
      and page_sk = cp_catalog_page_sk
    group by cp_catalog_page_id
), wsr as (
    select web_site_id,
           sum(sales_price) as sales,
           sum(profit) as profit,
           sum(return_amt) as returns_,
           sum(net_loss) as profit_loss
    from (select ws_web_site_sk as wsr_web_site_sk,
                 ws_sold_date_sk as date_sk,
                 ws_ext_sales_price as sales_price,
                 ws_net_profit as profit,
                 cast(0 as double) as return_amt,
                 cast(0 as double) as net_loss
          from web_sales
          union all
          select ws_web_site_sk as wsr_web_site_sk,
                 wr_returned_date_sk as date_sk,
                 cast(0 as double) as sales_price,
                 cast(0 as double) as profit,
                 wr_return_amt as return_amt,
                 wr_net_loss as net_loss
          from web_returns
          left outer join web_sales
            on (wr_item_sk = ws_item_sk
                and wr_order_number = ws_order_number)) salesreturns,
         date_dim, web_site
    where date_sk = d_date_sk
      and d_date between cast('2000-08-23' as date)
                     and cast('2000-08-23' as date) + interval '14' day
      and wsr_web_site_sk = web_site_sk
    group by web_site_id
)
select channel, id,
       sum(sales) as sales, sum(returns_) as returns_, sum(profit) as profit
from (select 'store channel' as channel, 'store' || s_store_id as id,
             sales, returns_, profit - profit_loss as profit
      from ssr
      union all
      select 'catalog channel' as channel,
             'catalog_page' || cp_catalog_page_id as id,
             sales, returns_, profit - profit_loss as profit
      from csr
      union all
      select 'web channel' as channel, 'web_site' || web_site_id as id,
             sales, returns_, profit - profit_loss as profit
      from wsr) x
group by rollup(channel, id)
order by channel, id
limit 100
""",
    18: """
select i_item_id, ca_country, ca_state, ca_county,
       avg(cast(cs_quantity as double)) as agg1,
       avg(cast(cs_list_price as double)) as agg2,
       avg(cast(cs_coupon_amt as double)) as agg3,
       avg(cast(cs_sales_price as double)) as agg4,
       avg(cast(cs_net_profit as double)) as agg5,
       avg(cast(c_birth_year as double)) as agg6,
       avg(cast(cd1.cd_dep_count as double)) as agg7
from catalog_sales, customer_demographics cd1, customer_demographics cd2,
     customer, customer_address, date_dim, item
where cs_sold_date_sk = d_date_sk
  and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd1.cd_demo_sk
  and cs_bill_customer_sk = c_customer_sk
  and cd1.cd_gender = 'F'
  and cd1.cd_education_status = 'Unknown'
  and c_current_cdemo_sk = cd2.cd_demo_sk
  and c_current_addr_sk = ca_address_sk
  and c_birth_month in (1, 6, 8, 9, 12, 2)
  and d_year = 1998
  and ca_state in ('MS', 'IN', 'ND', 'OK', 'NM', 'VA', 'MS')
group by rollup(i_item_id, ca_country, ca_state, ca_county)
order by ca_country, ca_state, ca_county, i_item_id
limit 100
""",
    22: """
select i_product_name, i_brand, i_class, i_category,
       avg(inv_quantity_on_hand) as qoh
from inventory, date_dim, item
where inv_date_sk = d_date_sk
  and inv_item_sk = i_item_sk
  and d_month_seq between 1200 and 1200 + 11
group by rollup(i_product_name, i_brand, i_class, i_category)
order by qoh, i_product_name, i_brand, i_class, i_category
limit 100
""",
    27: """
select i_item_id, s_state, grouping(s_state) as g_state,
       avg(ss_quantity) as agg1,
       avg(ss_list_price) as agg2,
       avg(ss_coupon_amt) as agg3,
       avg(ss_sales_price) as agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk
  and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and d_year = 2002
  and s_state = 'TN'
group by rollup(i_item_id, s_state)
order by i_item_id, s_state
limit 100
""",
    36: """
select gross_margin, i_category, i_class, lochierarchy, rank_within_parent
from (
    select sum(ss_net_profit) / sum(ss_ext_sales_price) as gross_margin,
           i_category, i_class,
           grouping(i_category) + grouping(i_class) as lochierarchy,
           rank() over (
               partition by grouping(i_category) + grouping(i_class),
                            case when grouping(i_class) = 0 then i_category end
               order by sum(ss_net_profit) / sum(ss_ext_sales_price) asc
           ) as rank_within_parent
    from store_sales, date_dim d1, item, store
    where d1.d_year = 2001
      and d1.d_date_sk = ss_sold_date_sk
      and i_item_sk = ss_item_sk
      and s_store_sk = ss_store_sk
      and s_state = 'TN'
    group by rollup(i_category, i_class)
) t
order by lochierarchy desc,
         case when lochierarchy = 0 then i_category end,
         rank_within_parent
limit 100
""",
    67: """
select *
from (select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
             d_moy, s_store_id, sumsales,
             rank() over (partition by i_category
                          order by sumsales desc) as rk
      from (select i_category, i_class, i_brand, i_product_name, d_year,
                   d_qoy, d_moy, s_store_id,
                   sum(coalesce(ss_sales_price * ss_quantity, 0)) as sumsales
            from store_sales, date_dim, store, item
            where ss_sold_date_sk = d_date_sk
              and ss_item_sk = i_item_sk
              and ss_store_sk = s_store_sk
              and d_month_seq between 1200 and 1200 + 11
            group by rollup(i_category, i_class, i_brand, i_product_name,
                            d_year, d_qoy, d_moy, s_store_id)) dw1) dw2
where rk <= 100
order by i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
         d_moy, s_store_id, sumsales, rk
limit 100
""",
    70: """
select sum(ss_net_profit) as total_sum, s_state, s_county,
       grouping(s_state) + grouping(s_county) as lochierarchy,
       rank() over (
           partition by grouping(s_state) + grouping(s_county),
                        case when grouping(s_county) = 0 then s_state end
           order by sum(ss_net_profit) desc
       ) as rank_within_parent
from store_sales, date_dim d1, store
where d1.d_month_seq between 1200 and 1200 + 11
  and d1.d_date_sk = ss_sold_date_sk
  and s_store_sk = ss_store_sk
  and s_state in (select s_state
                  from (select s_state,
                               rank() over (partition by s_state
                                            order by sum(ss_net_profit) desc) as ranking
                        from store_sales, store, date_dim
                        where d_month_seq between 1200 and 1200 + 11
                          and d_date_sk = ss_sold_date_sk
                          and s_store_sk = ss_store_sk
                        group by s_state) tmp1
                  where ranking <= 5)
group by rollup(s_state, s_county)
order by lochierarchy desc,
         case when lochierarchy = 0 then s_state end,
         rank_within_parent
limit 100
""",
    77: """
with ss as (
    select s_store_sk, sum(ss_ext_sales_price) as sales,
           sum(ss_net_profit) as profit
    from store_sales, date_dim, store
    where ss_sold_date_sk = d_date_sk
      and d_date between cast('2000-08-23' as date)
                     and cast('2000-08-23' as date) + interval '30' day
      and ss_store_sk = s_store_sk
    group by s_store_sk
), sr as (
    select s_store_sk, sum(sr_return_amt) as returns_,
           sum(sr_net_loss) as profit_loss
    from store_returns, date_dim, store
    where sr_returned_date_sk = d_date_sk
      and d_date between cast('2000-08-23' as date)
                     and cast('2000-08-23' as date) + interval '30' day
      and sr_store_sk = s_store_sk
    group by s_store_sk
), cs as (
    select cs_call_center_sk, sum(cs_ext_sales_price) as sales,
           sum(cs_net_profit) as profit
    from catalog_sales, date_dim
    where cs_sold_date_sk = d_date_sk
      and d_date between cast('2000-08-23' as date)
                     and cast('2000-08-23' as date) + interval '30' day
    group by cs_call_center_sk
), cr as (
    select sum(cr_return_amount) as returns_,
           sum(cr_net_loss) as profit_loss
    from catalog_returns, date_dim
    where cr_returned_date_sk = d_date_sk
      and d_date between cast('2000-08-23' as date)
                     and cast('2000-08-23' as date) + interval '30' day
), ws as (
    select wp_web_page_sk, sum(ws_ext_sales_price) as sales,
           sum(ws_net_profit) as profit
    from web_sales, date_dim, web_page
    where ws_sold_date_sk = d_date_sk
      and d_date between cast('2000-08-23' as date)
                     and cast('2000-08-23' as date) + interval '30' day
      and ws_web_page_sk = wp_web_page_sk
    group by wp_web_page_sk
), wr as (
    select wp_web_page_sk, sum(wr_return_amt) as returns_,
           sum(wr_net_loss) as profit_loss
    from web_returns, date_dim, web_page
    where wr_returned_date_sk = d_date_sk
      and d_date between cast('2000-08-23' as date)
                     and cast('2000-08-23' as date) + interval '30' day
      and wr_web_page_sk = wp_web_page_sk
    group by wp_web_page_sk
)
select channel, id, sum(sales) as sales, sum(returns_) as returns_,
       sum(profit) as profit
from (select 'store channel' as channel, ss.s_store_sk as id, sales,
             coalesce(returns_, 0) as returns_,
             profit - coalesce(profit_loss, 0) as profit
      from ss
      left join sr on ss.s_store_sk = sr.s_store_sk
      union all
      select 'catalog channel' as channel, cs_call_center_sk as id, sales,
             returns_, profit - profit_loss as profit
      from cs, cr
      union all
      select 'web channel' as channel, ws.wp_web_page_sk as id, sales,
             coalesce(returns_, 0) as returns_,
             profit - coalesce(profit_loss, 0) as profit
      from ws
      left join wr on ws.wp_web_page_sk = wr.wp_web_page_sk) x
group by rollup(channel, id)
order by channel, id
limit 100
""",
    80: """
with ssr as (
    select s_store_id as store_id,
           sum(ss_ext_sales_price) as sales,
           sum(coalesce(sr_return_amt, 0)) as returns_,
           sum(ss_net_profit - coalesce(sr_net_loss, 0)) as profit
    from store_sales
    left outer join store_returns
      on (ss_item_sk = sr_item_sk and ss_ticket_number = sr_ticket_number),
    date_dim, store, item, promotion
    where ss_sold_date_sk = d_date_sk
      and d_date between cast('2000-08-23' as date)
                     and cast('2000-08-23' as date) + interval '30' day
      and ss_store_sk = s_store_sk
      and ss_item_sk = i_item_sk
      and i_current_price > 50
      and ss_promo_sk = p_promo_sk
      and p_channel_tv = 'N'
    group by s_store_id
), csr as (
    select cp_catalog_page_id as catalog_page_id,
           sum(cs_ext_sales_price) as sales,
           sum(coalesce(cr_return_amount, 0)) as returns_,
           sum(cs_net_profit - coalesce(cr_net_loss, 0)) as profit
    from catalog_sales
    left outer join catalog_returns
      on (cs_item_sk = cr_item_sk and cs_order_number = cr_order_number),
    date_dim, catalog_page, item, promotion
    where cs_sold_date_sk = d_date_sk
      and d_date between cast('2000-08-23' as date)
                     and cast('2000-08-23' as date) + interval '30' day
      and cs_catalog_page_sk = cp_catalog_page_sk
      and cs_item_sk = i_item_sk
      and i_current_price > 50
      and cs_promo_sk = p_promo_sk
      and p_channel_tv = 'N'
    group by cp_catalog_page_id
), wsr as (
    select web_site_id,
           sum(ws_ext_sales_price) as sales,
           sum(coalesce(wr_return_amt, 0)) as returns_,
           sum(ws_net_profit - coalesce(wr_net_loss, 0)) as profit
    from web_sales
    left outer join web_returns
      on (ws_item_sk = wr_item_sk and ws_order_number = wr_order_number),
    date_dim, web_site, item, promotion
    where ws_sold_date_sk = d_date_sk
      and d_date between cast('2000-08-23' as date)
                     and cast('2000-08-23' as date) + interval '30' day
      and ws_web_site_sk = web_site_sk
      and ws_item_sk = i_item_sk
      and i_current_price > 50
      and ws_promo_sk = p_promo_sk
      and p_channel_tv = 'N'
    group by web_site_id
)
select channel, id, sum(sales) as sales, sum(returns_) as returns_,
       sum(profit) as profit
from (select 'store channel' as channel, 'store' || store_id as id,
             sales, returns_, profit
      from ssr
      union all
      select 'catalog channel' as channel,
             'catalog_page' || catalog_page_id as id,
             sales, returns_, profit
      from csr
      union all
      select 'web channel' as channel, 'web_site' || web_site_id as id,
             sales, returns_, profit
      from wsr) x
group by rollup(channel, id)
order by channel, id
limit 100
""",
    86: """
select sum(ws_net_paid) as total_sum, i_category, i_class,
       grouping(i_category) + grouping(i_class) as lochierarchy,
       rank() over (
           partition by grouping(i_category) + grouping(i_class),
                        case when grouping(i_class) = 0 then i_category end
           order by sum(ws_net_paid) desc
       ) as rank_within_parent
from web_sales, date_dim d1, item
where d1.d_month_seq between 1200 and 1200 + 11
  and d1.d_date_sk = ws_sold_date_sk
  and i_item_sk = ws_item_sk
group by rollup(i_category, i_class)
order by lochierarchy desc,
         case when lochierarchy = 0 then i_category end,
         rank_within_parent
limit 100
""",
    14: """
with cross_items as (
    select i_item_sk as ss_item_sk
    from item,
         (select iss.i_brand_id as brand_id, iss.i_class_id as class_id,
                 iss.i_category_id as category_id
          from store_sales, item iss, date_dim d1
          where ss_item_sk = iss.i_item_sk
            and ss_sold_date_sk = d1.d_date_sk
            and d1.d_year between 1999 and 1999 + 2
          intersect
          select ics.i_brand_id, ics.i_class_id, ics.i_category_id
          from catalog_sales, item ics, date_dim d2
          where cs_item_sk = ics.i_item_sk
            and cs_sold_date_sk = d2.d_date_sk
            and d2.d_year between 1999 and 1999 + 2
          intersect
          select iws.i_brand_id, iws.i_class_id, iws.i_category_id
          from web_sales, item iws, date_dim d3
          where ws_item_sk = iws.i_item_sk
            and ws_sold_date_sk = d3.d_date_sk
            and d3.d_year between 1999 and 1999 + 2) x
    where i_brand_id = brand_id
      and i_class_id = class_id
      and i_category_id = category_id
), avg_sales as (
    select avg(quantity * list_price) as average_sales
    from (select ss_quantity as quantity, ss_list_price as list_price
          from store_sales, date_dim
          where ss_sold_date_sk = d_date_sk
            and d_year between 1999 and 1999 + 2
          union all
          select cs_quantity as quantity, cs_list_price as list_price
          from catalog_sales, date_dim
          where cs_sold_date_sk = d_date_sk
            and d_year between 1999 and 1999 + 2
          union all
          select ws_quantity as quantity, ws_list_price as list_price
          from web_sales, date_dim
          where ws_sold_date_sk = d_date_sk
            and d_year between 1999 and 1999 + 2) x
)
select channel, i_brand_id, i_class_id, i_category_id,
       sum(sales) as sum_sales, sum(number_sales) as sum_number_sales
from (select 'store' as channel, i_brand_id, i_class_id, i_category_id,
             sum(ss_quantity * ss_list_price) as sales,
             count(*) as number_sales
      from store_sales, item, date_dim
      where ss_item_sk in (select ss_item_sk from cross_items)
        and ss_item_sk = i_item_sk
        and ss_sold_date_sk = d_date_sk
        and d_year = 1999 + 2 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(ss_quantity * ss_list_price)
             > (select average_sales from avg_sales)
      union all
      select 'catalog' as channel, i_brand_id, i_class_id, i_category_id,
             sum(cs_quantity * cs_list_price) as sales,
             count(*) as number_sales
      from catalog_sales, item, date_dim
      where cs_item_sk in (select ss_item_sk from cross_items)
        and cs_item_sk = i_item_sk
        and cs_sold_date_sk = d_date_sk
        and d_year = 1999 + 2 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(cs_quantity * cs_list_price)
             > (select average_sales from avg_sales)
      union all
      select 'web' as channel, i_brand_id, i_class_id, i_category_id,
             sum(ws_quantity * ws_list_price) as sales,
             count(*) as number_sales
      from web_sales, item, date_dim
      where ws_item_sk in (select ss_item_sk from cross_items)
        and ws_item_sk = i_item_sk
        and ws_sold_date_sk = d_date_sk
        and d_year = 1999 + 2 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(ws_quantity * ws_list_price)
             > (select average_sales from avg_sales)) y
group by rollup(channel, i_brand_id, i_class_id, i_category_id)
order by channel, i_brand_id, i_class_id, i_category_id
limit 100
""",
    69: """
select cd_gender, cd_marital_status, cd_education_status,
       count(*) as cnt1, cd_purchase_estimate, count(*) as cnt2,
       cd_credit_rating, count(*) as cnt3
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and ca_state in ('KY', 'GA', 'NM')
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2001 and d_moy between 4 and 4 + 2)
  and (not exists (select * from web_sales, date_dim
                   where c.c_customer_sk = ws_bill_customer_sk
                     and ws_sold_date_sk = d_date_sk
                     and d_year = 2001 and d_moy between 4 and 4 + 2)
       and not exists (select * from catalog_sales, date_dim
                       where c.c_customer_sk = cs_ship_customer_sk
                         and cs_sold_date_sk = d_date_sk
                         and d_year = 2001 and d_moy between 4 and 4 + 2))
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
limit 100
""",
    71: """
select i_brand_id as brand_id, i_brand as brand, t_hour, t_minute,
       sum(ext_price) as ext_price
from item,
     (select ws_ext_sales_price as ext_price,
             ws_sold_date_sk as sold_date_sk,
             ws_item_sk as sold_item_sk,
             ws_sold_time_sk as time_sk
      from web_sales, date_dim
      where d_date_sk = ws_sold_date_sk and d_moy = 11 and d_year = 1999
      union all
      select cs_ext_sales_price as ext_price,
             cs_sold_date_sk as sold_date_sk,
             cs_item_sk as sold_item_sk,
             cs_sold_time_sk as time_sk
      from catalog_sales, date_dim
      where d_date_sk = cs_sold_date_sk and d_moy = 11 and d_year = 1999
      union all
      select ss_ext_sales_price as ext_price,
             ss_sold_date_sk as sold_date_sk,
             ss_item_sk as sold_item_sk,
             ss_sold_time_sk as time_sk
      from store_sales, date_dim
      where d_date_sk = ss_sold_date_sk and d_moy = 11 and d_year = 1999) tmp,
     time_dim
where sold_item_sk = i_item_sk
  and i_manager_id = 1
  and time_sk = t_time_sk
  and (t_meal_time = 'breakfast' or t_meal_time = 'dinner')
group by i_brand, i_brand_id, t_hour, t_minute
order by ext_price desc, brand_id, t_hour, t_minute
""",
    72: """
select i_item_desc, w_warehouse_name, d1.d_week_seq,
       sum(case when p_promo_sk is null then 1 else 0 end) as no_promo,
       sum(case when p_promo_sk is not null then 1 else 0 end) as promo,
       count(*) as total_cnt
from catalog_sales
join inventory on (cs_item_sk = inv_item_sk)
join warehouse on (w_warehouse_sk = inv_warehouse_sk)
join item on (i_item_sk = cs_item_sk)
join customer_demographics on (cs_bill_cdemo_sk = cd_demo_sk)
join household_demographics on (cs_bill_hdemo_sk = hd_demo_sk)
join date_dim d1 on (cs_sold_date_sk = d1.d_date_sk)
join date_dim d2 on (inv_date_sk = d2.d_date_sk)
join date_dim d3 on (cs_ship_date_sk = d3.d_date_sk)
left outer join promotion on (cs_promo_sk = p_promo_sk)
left outer join catalog_returns
  on (cr_item_sk = cs_item_sk and cr_order_number = cs_order_number)
where d1.d_week_seq = d2.d_week_seq
  and inv_quantity_on_hand < cs_quantity
  and d3.d_date > d1.d_date + interval '5' day
  and hd_buy_potential = '>10000'
  and d1.d_year = 1999
  and cd_marital_status = 'D'
group by i_item_desc, w_warehouse_name, d1.d_week_seq
order by total_cnt desc, i_item_desc, w_warehouse_name, d1.d_week_seq
limit 100
""",
    74: """
with year_total as (
    select c_customer_id as customer_id,
           c_first_name as customer_first_name,
           c_last_name as customer_last_name,
           d_year as year_,
           sum(ss_net_paid) as year_total,
           's' as sale_type
    from customer, store_sales, date_dim
    where c_customer_sk = ss_customer_sk
      and ss_sold_date_sk = d_date_sk
      and d_year in (1999, 1999 + 1)
    group by c_customer_id, c_first_name, c_last_name, d_year
    union all
    select c_customer_id as customer_id,
           c_first_name as customer_first_name,
           c_last_name as customer_last_name,
           d_year as year_,
           sum(ws_net_paid) as year_total,
           'w' as sale_type
    from customer, web_sales, date_dim
    where c_customer_sk = ws_bill_customer_sk
      and ws_sold_date_sk = d_date_sk
      and d_year in (1999, 1999 + 1)
    group by c_customer_id, c_first_name, c_last_name, d_year
)
select t_s_secyear.customer_id, t_s_secyear.customer_first_name,
       t_s_secyear.customer_last_name
from year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_secyear.customer_id
  and t_s_firstyear.customer_id = t_w_firstyear.customer_id
  and t_s_firstyear.sale_type = 's'
  and t_w_firstyear.sale_type = 'w'
  and t_s_secyear.sale_type = 's'
  and t_w_secyear.sale_type = 'w'
  and t_s_firstyear.year_ = 1999
  and t_s_secyear.year_ = 1999 + 1
  and t_w_firstyear.year_ = 1999
  and t_w_secyear.year_ = 1999 + 1
  and t_s_firstyear.year_total > 0
  and t_w_firstyear.year_total > 0
  and case when t_w_firstyear.year_total > 0
           then t_w_secyear.year_total / t_w_firstyear.year_total
           else null end
      > case when t_s_firstyear.year_total > 0
             then t_s_secyear.year_total / t_s_firstyear.year_total
             else null end
order by 1, 2, 3
limit 100
""",
    75: """
with all_sales as (
    select d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
           sum(sales_cnt) as sales_cnt, sum(sales_amt) as sales_amt
    from (select d_year, i_brand_id, i_class_id, i_category_id,
                 i_manufact_id,
                 cs_quantity - coalesce(cr_return_quantity, 0) as sales_cnt,
                 cs_ext_sales_price - coalesce(cr_return_amount, 0.0) as sales_amt
          from catalog_sales
          join item on i_item_sk = cs_item_sk
          join date_dim on d_date_sk = cs_sold_date_sk
          left join catalog_returns
            on (cs_order_number = cr_order_number and cs_item_sk = cr_item_sk)
          where i_category = 'Books'
          union
          select d_year, i_brand_id, i_class_id, i_category_id,
                 i_manufact_id,
                 ss_quantity - coalesce(sr_return_quantity, 0) as sales_cnt,
                 ss_ext_sales_price - coalesce(sr_return_amt, 0.0) as sales_amt
          from store_sales
          join item on i_item_sk = ss_item_sk
          join date_dim on d_date_sk = ss_sold_date_sk
          left join store_returns
            on (ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk)
          where i_category = 'Books'
          union
          select d_year, i_brand_id, i_class_id, i_category_id,
                 i_manufact_id,
                 ws_quantity - coalesce(wr_return_quantity, 0) as sales_cnt,
                 ws_ext_sales_price - coalesce(wr_return_amt, 0.0) as sales_amt
          from web_sales
          join item on i_item_sk = ws_item_sk
          join date_dim on d_date_sk = ws_sold_date_sk
          left join web_returns
            on (ws_order_number = wr_order_number and ws_item_sk = wr_item_sk)
          where i_category = 'Books') sales_detail
    group by d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id
)
select prev_yr.d_year as prev_year, curr_yr.d_year as year_,
       curr_yr.i_brand_id, curr_yr.i_class_id, curr_yr.i_category_id,
       curr_yr.i_manufact_id, prev_yr.sales_cnt as prev_yr_cnt,
       curr_yr.sales_cnt as curr_yr_cnt,
       curr_yr.sales_cnt - prev_yr.sales_cnt as sales_cnt_diff,
       curr_yr.sales_amt - prev_yr.sales_amt as sales_amt_diff
from all_sales curr_yr, all_sales prev_yr
where curr_yr.i_brand_id = prev_yr.i_brand_id
  and curr_yr.i_class_id = prev_yr.i_class_id
  and curr_yr.i_category_id = prev_yr.i_category_id
  and curr_yr.i_manufact_id = prev_yr.i_manufact_id
  and curr_yr.d_year = 2002
  and prev_yr.d_year = 2002 - 1
  and cast(curr_yr.sales_cnt as double) / cast(prev_yr.sales_cnt as double) < 0.9
order by sales_cnt_diff, sales_amt_diff
limit 100
""",
    76: """
select channel, col_name, d_year, d_qoy, i_category,
       count(*) as sales_cnt, sum(ext_sales_price) as sales_amt
from (
    select 'store' as channel, 'ss_store_sk' as col_name, d_year, d_qoy,
           i_category, ss_ext_sales_price as ext_sales_price
    from store_sales, item, date_dim
    where ss_store_sk is null
      and ss_sold_date_sk = d_date_sk
      and ss_item_sk = i_item_sk
    union all
    select 'web' as channel, 'ws_ship_customer_sk' as col_name, d_year,
           d_qoy, i_category, ws_ext_sales_price as ext_sales_price
    from web_sales, item, date_dim
    where ws_ship_customer_sk is null
      and ws_sold_date_sk = d_date_sk
      and ws_item_sk = i_item_sk
    union all
    select 'catalog' as channel, 'cs_ship_addr_sk' as col_name, d_year,
           d_qoy, i_category, cs_ext_sales_price as ext_sales_price
    from catalog_sales, item, date_dim
    where cs_ship_addr_sk is null
      and cs_sold_date_sk = d_date_sk
      and cs_item_sk = i_item_sk) foo
group by channel, col_name, d_year, d_qoy, i_category
order by channel, col_name, d_year, d_qoy, i_category
limit 100
""",
    78: """
with ws as (
    select d_year as ws_sold_year, ws_item_sk,
           ws_bill_customer_sk as ws_customer_sk,
           sum(ws_quantity) as ws_qty,
           sum(ws_wholesale_cost) as ws_wc,
           sum(ws_sales_price) as ws_sp
    from web_sales
    left join web_returns
      on wr_order_number = ws_order_number and ws_item_sk = wr_item_sk
    join date_dim on ws_sold_date_sk = d_date_sk
    where wr_order_number is null
    group by d_year, ws_item_sk, ws_bill_customer_sk
), cs as (
    select d_year as cs_sold_year, cs_item_sk,
           cs_bill_customer_sk as cs_customer_sk,
           sum(cs_quantity) as cs_qty,
           sum(cs_wholesale_cost) as cs_wc,
           sum(cs_sales_price) as cs_sp
    from catalog_sales
    left join catalog_returns
      on cr_order_number = cs_order_number and cs_item_sk = cr_item_sk
    join date_dim on cs_sold_date_sk = d_date_sk
    where cr_order_number is null
    group by d_year, cs_item_sk, cs_bill_customer_sk
), ss as (
    select d_year as ss_sold_year, ss_item_sk,
           ss_customer_sk,
           sum(ss_quantity) as ss_qty,
           sum(ss_wholesale_cost) as ss_wc,
           sum(ss_sales_price) as ss_sp
    from store_sales
    left join store_returns
      on sr_ticket_number = ss_ticket_number and ss_item_sk = sr_item_sk
    join date_dim on ss_sold_date_sk = d_date_sk
    where sr_ticket_number is null
    group by d_year, ss_item_sk, ss_customer_sk
)
select ss_item_sk,
       round(ss_qty / (coalesce(ws_qty, 0) + coalesce(cs_qty, 0)), 2) as ratio,
       ss_qty as store_qty, ss_wc as store_wholesale_cost,
       ss_sp as store_sales_price,
       coalesce(ws_qty, 0) + coalesce(cs_qty, 0) as other_chan_qty,
       coalesce(ws_wc, 0) + coalesce(cs_wc, 0) as other_chan_wholesale_cost,
       coalesce(ws_sp, 0) + coalesce(cs_sp, 0) as other_chan_sales_price
from ss
left join ws on (ws_sold_year = ss_sold_year and ws_item_sk = ss_item_sk
                 and ws_customer_sk = ss_customer_sk)
left join cs on (cs_sold_year = ss_sold_year and cs_item_sk = ss_item_sk
                 and cs_customer_sk = ss_customer_sk)
where (coalesce(ws_qty, 0) > 0 or coalesce(cs_qty, 0) > 0)
  and ss_sold_year = 2000
order by ss_item_sk, ss_qty desc, ss_wc desc, ss_sp desc,
         other_chan_qty, other_chan_wholesale_cost, other_chan_sales_price,
         ratio
limit 100
""",
    81: """
with customer_total_return as (
    select cr_returning_customer_sk as ctr_customer_sk,
           ca_state as ctr_state,
           sum(cr_return_amt_inc_tax) as ctr_total_return
    from catalog_returns, date_dim, customer_address
    where cr_returned_date_sk = d_date_sk
      and d_year = 2000
      and cr_returning_addr_sk = ca_address_sk
    group by cr_returning_customer_sk, ca_state
)
select c_customer_id, c_salutation, c_first_name, c_last_name,
       ca_street_number, ca_street_name, ca_street_type, ca_suite_number,
       ca_city, ca_county, ca_state, ca_zip, ca_country, ca_gmt_offset,
       ca_location_type, ctr_total_return
from customer_total_return ctr1, customer_address, customer
where ctr1.ctr_total_return > (select avg(ctr_total_return) * 1.2
                               from customer_total_return ctr2
                               where ctr1.ctr_state = ctr2.ctr_state)
  and ca_address_sk = c_current_addr_sk
  and ca_state = 'GA'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, c_salutation, c_first_name, c_last_name,
         ca_street_number, ca_street_name, ca_street_type, ca_suite_number,
         ca_city, ca_county, ca_state, ca_zip, ca_country, ca_gmt_offset,
         ca_location_type, ctr_total_return
limit 100
""",
    83: """
with sr_items as (
    select i_item_id as item_id, sum(sr_return_quantity) as sr_item_qty
    from store_returns, item, date_dim
    where sr_item_sk = i_item_sk
      and d_date in (select d_date from date_dim
                     where d_week_seq in (select d_week_seq from date_dim
                                          where d_date in ('2000-06-30',
                                                           '2000-09-27',
                                                           '2000-11-17')))
      and sr_returned_date_sk = d_date_sk
    group by i_item_id
), cr_items as (
    select i_item_id as item_id, sum(cr_return_quantity) as cr_item_qty
    from catalog_returns, item, date_dim
    where cr_item_sk = i_item_sk
      and d_date in (select d_date from date_dim
                     where d_week_seq in (select d_week_seq from date_dim
                                          where d_date in ('2000-06-30',
                                                           '2000-09-27',
                                                           '2000-11-17')))
      and cr_returned_date_sk = d_date_sk
    group by i_item_id
), wr_items as (
    select i_item_id as item_id, sum(wr_return_quantity) as wr_item_qty
    from web_returns, item, date_dim
    where wr_item_sk = i_item_sk
      and d_date in (select d_date from date_dim
                     where d_week_seq in (select d_week_seq from date_dim
                                          where d_date in ('2000-06-30',
                                                           '2000-09-27',
                                                           '2000-11-17')))
      and wr_returned_date_sk = d_date_sk
    group by i_item_id
)
select sr_items.item_id, sr_item_qty,
       cast(sr_item_qty as double)
       / cast(sr_item_qty + cr_item_qty + wr_item_qty as double) / 3.0 * 100
       as sr_dev,
       cr_item_qty,
       cast(cr_item_qty as double)
       / cast(sr_item_qty + cr_item_qty + wr_item_qty as double) / 3.0 * 100
       as cr_dev,
       wr_item_qty,
       cast(wr_item_qty as double)
       / cast(sr_item_qty + cr_item_qty + wr_item_qty as double) / 3.0 * 100
       as wr_dev,
       cast(sr_item_qty + cr_item_qty + wr_item_qty as double) / 3.0
       as average
from sr_items, cr_items, wr_items
where sr_items.item_id = cr_items.item_id
  and sr_items.item_id = wr_items.item_id
order by sr_items.item_id, sr_item_qty
limit 100
""",
    84: """
select c_customer_id as customer_id,
       coalesce(c_last_name, '') || ', ' || coalesce(c_first_name, '')
       as customername
from customer, customer_address, customer_demographics,
     household_demographics, income_band, store_returns
where ca_city = 'Edgewood'
  and c_current_addr_sk = ca_address_sk
  and ib_lower_bound >= 38128
  and ib_upper_bound <= 38128 + 50000
  and ib_income_band_sk = hd_income_band_sk
  and cd_demo_sk = c_current_cdemo_sk
  and hd_demo_sk = c_current_hdemo_sk
  and sr_cdemo_sk = cd_demo_sk
order by c_customer_id
limit 100
""",
    85: """
select substr(r_reason_desc, 1, 20) as reason_desc,
       avg(ws_quantity) as avg_q,
       avg(wr_refunded_cash) as avg_cash,
       avg(wr_fee) as avg_fee
from web_sales, web_returns, web_page, customer_demographics cd1,
     customer_demographics cd2, customer_address, date_dim, reason
where ws_web_page_sk = wp_web_page_sk
  and ws_item_sk = wr_item_sk
  and ws_order_number = wr_order_number
  and ws_sold_date_sk = d_date_sk
  and d_year = 2000
  and cd1.cd_demo_sk = wr_refunded_cdemo_sk
  and cd2.cd_demo_sk = wr_returning_cdemo_sk
  and ca_address_sk = wr_refunded_addr_sk
  and r_reason_sk = wr_reason_sk
  and ((cd1.cd_marital_status = 'M'
        and cd1.cd_marital_status = cd2.cd_marital_status
        and cd1.cd_education_status = 'Advanced Degree'
        and cd1.cd_education_status = cd2.cd_education_status
        and ws_sales_price between 100.00 and 150.00)
       or (cd1.cd_marital_status = 'S'
           and cd1.cd_marital_status = cd2.cd_marital_status
           and cd1.cd_education_status = 'College'
           and cd1.cd_education_status = cd2.cd_education_status
           and ws_sales_price between 50.00 and 100.00)
       or (cd1.cd_marital_status = 'W'
           and cd1.cd_marital_status = cd2.cd_marital_status
           and cd1.cd_education_status = '2 yr Degree'
           and cd1.cd_education_status = cd2.cd_education_status
           and ws_sales_price between 150.00 and 200.00))
  and ((ca_country = 'United States'
        and ca_state in ('IN', 'OH', 'NJ')
        and ws_net_profit between 100 and 200)
       or (ca_country = 'United States'
           and ca_state in ('WI', 'CT', 'KY')
           and ws_net_profit between 150 and 300)
       or (ca_country = 'United States'
           and ca_state in ('LA', 'IA', 'AR')
           and ws_net_profit between 50 and 250))
group by r_reason_desc
order by reason_desc, avg_q, avg_cash, avg_fee
limit 100
""",
    92: """
select sum(ws_ext_discount_amt) as excess_discount_amount
from web_sales, item, date_dim
where i_manufact_id = 66
  and i_item_sk = ws_item_sk
  and d_date between cast('2000-01-27' as date)
                 and cast('2000-01-27' as date) + interval '90' day
  and d_date_sk = ws_sold_date_sk
  and ws_ext_discount_amt > (
        select 1.3 * avg(ws_ext_discount_amt)
        from web_sales, date_dim
        where ws_item_sk = i_item_sk
          and d_date between cast('2000-01-27' as date)
                         and cast('2000-01-27' as date) + interval '90' day
          and d_date_sk = ws_sold_date_sk)
order by excess_discount_amount
limit 100
""",
    94: """
select count(distinct ws_order_number) as order_count,
       sum(ws_ext_ship_cost) as total_shipping_cost,
       sum(ws_net_profit) as total_net_profit
from web_sales ws1, date_dim, customer_address, web_site
where d_date between cast('2000-02-01' as date)
                 and cast('2000-02-01' as date) + interval '60' day
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk
  and ca_state = 'GA'
  and ws1.ws_web_site_sk = web_site_sk
  and exists (select * from web_sales ws2
              where ws1.ws_order_number = ws2.ws_order_number
                and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
  and not exists (select * from web_returns wr1
                  where ws1.ws_order_number = wr1.wr_order_number)
order by order_count
limit 100
""",
    95: """
with ws_wh as (
    select ws1.ws_order_number, ws1.ws_warehouse_sk as wh1,
           ws2.ws_warehouse_sk as wh2
    from web_sales ws1, web_sales ws2
    where ws1.ws_order_number = ws2.ws_order_number
      and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk
)
select count(distinct ws_order_number) as order_count,
       sum(ws_ext_ship_cost) as total_shipping_cost,
       sum(ws_net_profit) as total_net_profit
from web_sales ws1, date_dim, customer_address, web_site
where d_date between cast('2000-02-01' as date)
                 and cast('2000-02-01' as date) + interval '60' day
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk
  and ca_state = 'GA'
  and ws1.ws_web_site_sk = web_site_sk
  and ws1.ws_order_number in (select ws_order_number from ws_wh)
  and ws1.ws_order_number in (select wr_order_number
                              from web_returns, ws_wh
                              where wr_order_number = ws_wh.ws_order_number)
order by order_count
limit 100
""",
    97: """
with ssci as (
    select ss_customer_sk as customer_sk, ss_item_sk as item_sk
    from store_sales, date_dim
    where ss_sold_date_sk = d_date_sk
      and d_month_seq between 1200 and 1200 + 11
    group by ss_customer_sk, ss_item_sk
), csci as (
    select cs_bill_customer_sk as customer_sk, cs_item_sk as item_sk
    from catalog_sales, date_dim
    where cs_sold_date_sk = d_date_sk
      and d_month_seq between 1200 and 1200 + 11
    group by cs_bill_customer_sk, cs_item_sk
)
select sum(case when ssci.customer_sk is not null
                 and csci.customer_sk is null then 1 else 0 end)
       as store_only,
       sum(case when ssci.customer_sk is null
                 and csci.customer_sk is not null then 1 else 0 end)
       as catalog_only,
       sum(case when ssci.customer_sk is not null
                 and csci.customer_sk is not null then 1 else 0 end)
       as store_and_catalog
from ssci
full outer join csci
  on (ssci.customer_sk = csci.customer_sk and ssci.item_sk = csci.item_sk)
limit 100
""",
}
